"""R005 — tracer-leak, retargeted: a graph leak.

JAX's bug is a tracer stored where it outlives the trace. PyTorch's bug
of the same class is a tensor that carries autograd history stored where
it outlives the step: every such tensor keeps its whole graph (each
saved activation of the forward) alive, so memory grows step by step and
the step's buffers are never reused — the classic ``total_loss += loss``.

A value carries history when, outside ``torch.no_grad()``/``torch.
inference_mode()`` (a ``with`` block or a decorator), it is the output of
a call of an ``nn.Module`` instance (the launch registry's modules) or is
derived from one by torch ops, functional calls, arithmetic, indexing or
tensor methods — ``.detach()``, ``.item()``, ``.tolist()``, ``.numpy()``
and ``float()``/``int()`` end the history. The rule flags such a value
when it is

* assigned to an attribute (``self.last_out = out``) or through a
  ``global``/``nonlocal`` name;
* put into a container that outlives the step: ``.append``/``.extend``/
  ``.add``/``.insert``/``.setdefault``/``.update`` or an item store on a
  ``self`` attribute, a global, a parameter or a closure variable, or, in
  a loop, on a container bound before the loop;
* accumulated across a loop's iterations (``acc += loss`` with ``acc``
  bound before the loop).
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from waternet_tpu_torch.analysis.core import (
    FUNCTION_NODES,
    LOOP_NODES,
    Finding,
    ModuleModel,
    ancestors,
    flatten_targets,
    in_context,
    iter_body,
)
from waternet_tpu_torch.analysis.registry import Rule, register

NO_GRAD = frozenset({"torch.no_grad", "torch.inference_mode", "torch.autograd.no_grad",
                     "torch.autograd.grad_mode.no_grad"})
_ENDS_HISTORY = frozenset({"detach", "detach_", "item", "tolist", "numpy", "requires_grad_"})
_MUTATORS = frozenset({"append", "extend", "insert", "add", "update", "setdefault", "appendleft"})


def _carries(model: ModuleModel, expr: ast.AST, hist: set, depth: int = 0) -> bool:
    if depth > 10 or expr is None:
        return False
    d = depth + 1
    if isinstance(expr, ast.Name):
        return expr.id in hist
    if isinstance(expr, ast.Call):
        f = expr.func
        if model.module_call(expr):
            return not in_context(expr, model, NO_GRAD)
        name = model.resolve(f) or ""
        if name in ("float", "int", "bool", "len", "str", "repr", "print"):
            return False
        if name.startswith("torch."):
            args = list(expr.args) + [k.value for k in expr.keywords]
            args = [e for a in args for e in (a.elts if isinstance(a, (ast.List, ast.Tuple)) else [a])]
            return any(_carries(model, a, hist, d) for a in args)
        if isinstance(f, ast.Attribute):
            if f.attr in _ENDS_HISTORY:
                return False
            return _carries(model, f.value, hist, d)
        return False
    if isinstance(expr, ast.BinOp):
        return _carries(model, expr.left, hist, d) or _carries(model, expr.right, hist, d)
    if isinstance(expr, ast.UnaryOp):
        return _carries(model, expr.operand, hist, d)
    if isinstance(expr, ast.Subscript):
        return _carries(model, expr.value, hist, d)
    if isinstance(expr, (ast.Tuple, ast.List)):
        return any(_carries(model, e, hist, d) for e in expr.elts)
    if isinstance(expr, ast.Dict):
        return any(_carries(model, v, hist, d) for v in expr.values)
    return False


def _history_names(model: ModuleModel, fn) -> set:
    """Names of ``fn`` assigned (anywhere in it, outside no-grad blocks)
    from a value that carries autograd history; iterated to a fixpoint."""
    hist: set = set()
    assigns = [n for n in iter_body(fn) if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign))]
    changed = True
    while changed:
        changed = False
        for node in assigns:
            if node.value is None or in_context(node, model, NO_GRAD):
                continue
            if not _carries(model, node.value, hist):
                continue
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                for leaf in flatten_targets(t):
                    if isinstance(leaf, ast.Name) and leaf.id not in hist:
                        hist.add(leaf.id)
                        changed = True
    return hist


def _local_names(fn) -> set:
    names = set()
    for node in iter_body(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            names.add(node.id)
    return names


def _params(fn) -> set:
    a = fn.args
    return {p.arg for p in a.args + a.posonlyargs + a.kwonlyargs}


def _binds_in(loop, name: str) -> bool:
    """True when ``name`` is (re)bound in ``loop``: by an assignment, a
    ``for`` target (the loop's own included) or a ``with ... as``."""
    for node in ast.walk(loop):
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AnnAssign, ast.For, ast.AsyncFor)):
            targets = [node.target]
        elif isinstance(node, ast.withitem) and node.optional_vars is not None:
            targets = [node.optional_vars]
        else:
            continue
        if any(isinstance(t, ast.Name) and t.id == name for tgt in targets for t in flatten_targets(tgt)):
            return True
    return False


def _bound_before_loop(name: str, node: ast.AST, fn) -> Optional[ast.AST]:
    """The innermost loop around ``node`` (within ``fn``) that does not
    bind ``name``: the value outlives that loop's iterations."""
    for anc in ancestors(node):
        if anc is fn:
            return None
        if isinstance(anc, LOOP_NODES) and not _binds_in(anc, name):
            return anc
    return None


@register
class GraphLeak(Rule):
    id = "R005"
    name = "tracer-leak"
    description = (
        "a tensor that carries autograd history (a forward's output, a "
        "loss) is stored into self/globals/nonlocals or a container that "
        "outlives the step, keeping every step's graph alive"
    )

    def check(self, model: ModuleModel) -> Iterator[Finding]:
        for fn in ast.walk(model.tree):
            if not isinstance(fn, FUNCTION_NODES):
                continue
            hist = _history_names(model, fn)
            if not hist and not any(model.module_call(c) for c in iter_body(fn) if isinstance(c, ast.Call)):
                continue
            declared = set()
            for node in iter_body(fn):
                if isinstance(node, (ast.Global, ast.Nonlocal)):
                    declared.update(node.names)
            locals_ = _local_names(fn) - declared
            params = _params(fn)
            for node in iter_body(fn):
                yield from self._check(model, fn, node, hist, declared, locals_, params)

    def _check(self, model, fn, node, hist, declared, locals_, params):
        if in_context(node, model, NO_GRAD):
            return
        if isinstance(node, (ast.Assign, ast.AnnAssign)) and node.value is not None:
            if not _carries(model, node.value, hist):
                return
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                for leaf in flatten_targets(t):
                    where = None
                    if isinstance(leaf, ast.Attribute):
                        where = f"attribute `{ast.unparse(leaf)}`"
                    elif isinstance(leaf, ast.Name) and leaf.id in declared:
                        where = f"global/nonlocal `{leaf.id}`"
                    elif isinstance(leaf, ast.Subscript):
                        base = leaf.value
                        if isinstance(base, ast.Attribute) or (
                            isinstance(base, ast.Name)
                            and (base.id not in locals_ or base.id in declared or base.id in params)
                        ):
                            where = f"the outliving container `{ast.unparse(base)}`"
                    if where:
                        yield self._leak(model, leaf, where, fn)
        elif isinstance(node, ast.AugAssign) and isinstance(node.target, ast.Name):
            if not _carries(model, node.value, hist):
                return
            loop = _bound_before_loop(node.target.id, node, fn)
            if node.target.id in declared:
                yield self._leak(model, node, f"global/nonlocal `{node.target.id}`", fn)
            elif loop is not None:
                yield self._leak(model, node, f"`{node.target.id}`, accumulated across the loop at "
                                 f"line {loop.lineno}", fn)
        elif isinstance(node, ast.Call):
            f = node.func
            if not (isinstance(f, ast.Attribute) and f.attr in _MUTATORS):
                return
            if not any(_carries(model, a, hist) for a in node.args):
                return
            base = f.value
            if isinstance(base, ast.Attribute):
                yield self._leak(model, node, f"the outliving container `{ast.unparse(base)}`", fn)
            elif isinstance(base, ast.Name):
                if base.id in declared or base.id in params or base.id not in locals_:
                    yield self._leak(model, node, f"the outliving container `{base.id}`", fn)
                else:
                    loop = _bound_before_loop(base.id, node, fn)
                    if loop is not None:
                        yield self._leak(model, node, f"`{base.id}`, which outlives the loop at "
                                         f"line {loop.lineno}", fn)

    def _leak(self, model, node, where, fn) -> Finding:
        return self.finding(
            model,
            node,
            f"a tensor with autograd history is stored into {where} in `{fn.name}`: "
            "it keeps the step's whole graph (every saved activation) alive. "
            "Store `.detach()` (or the value read once, after the loop)",
        )
