"""R003 — host-sync-in-hot-loop.

The engine's throughput rests on the deferred-metrics-fetch discipline:
code that enqueues device work once per step must not also make the host
wait for the device. Each wait drains the CUDA queue and serializes host
and device: the reference trainer's 8+ syncs a step. The sanctioned shape
is ``TrainingEngine._drive_train_epoch``: collect the steps' metric
tensors, read them once after the loop (``_fetch_floats``). A step that
syncs also cannot be captured into a CUDA graph.

What counts as a sync (each one confirmed on an H100 under
``torch.cuda.set_sync_debug_mode("warn")``, except ``torch.cuda.
synchronize()``, ``Event.synchronize()`` and ``torch.equal``, which that
mode does not report; ``chip_smoke.py`` phase 16 re-checks the list):

* ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")`` of
  a device tensor, and ``float()``/``int()``/``bool()`` of one;
* a device tensor as an ``if``/``while``/``assert`` test;
* ``torch.equal``/``allclose`` (a Python bool);
* ``nonzero()``, ``unique()``, ``masked_select()``, ``bincount()``,
  ``repeat_interleave()`` without ``output_size``, and boolean-mask
  indexing (``x[x > 0]``): their output size is read back;
* a copy from pageable host memory to the device: ``.to(device)`` or
  ``.cuda()`` of a host tensor without ``non_blocking=True``, and
  ``torch.tensor``/``torch.as_tensor`` of host data with ``device=``;
* ``torch.cuda.synchronize()`` and ``Event``/``Stream.synchronize()``.

Whether an expression is a device tensor is resolved without types
(:func:`~waternet_tpu_torch.analysis.core.tensor_kind`), so numpy values
such as ``np.flatnonzero(...).tolist()`` stay clean.

Where the rule looks (the hot code): a ``for``/``while`` loop that
enqueues device work (its body calls a callable of the launch registry,
directly or through the functions it calls), and every step method
(``def train_step*``/``eval_step*``), which runs once per step by
definition. From there the rule follows the calls it can resolve (nested
and module functions, ``self`` methods, functions imported from the
scanned modules) and reports each sync where it is, with the chain that
reaches it: the same file and line that ``set_sync_debug_mode`` names on
the card. A loop that only fetches (``for m in pending: float(...)``)
launches nothing and stays clean.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from waternet_tpu_torch.analysis.core import (
    DEVICE,
    FUNCTION_NODES,
    HOST,
    LAUNCH_METHOD_RE,
    LOOP_NODES,
    Finding,
    FunctionIndex,
    ModuleModel,
    binds_param,
    enclosing_class,
    is_true,
    iter_body,
    kwarg,
    scope_chain,
    tensor_kind,
)
from waternet_tpu_torch.analysis.registry import Rule, register

_SYNC_CALLS = {
    "torch.cuda.synchronize": "torch.cuda.synchronize() waits for all of the device's work",
    "torch.nonzero": "torch.nonzero() reads its output size back from the device",
    "torch.argwhere": "torch.argwhere() reads its output size back from the device",
    "torch.unique": "torch.unique() reads its output size back from the device",
    "torch.unique_consecutive": "torch.unique_consecutive() reads its output size back",
    "torch.masked_select": "torch.masked_select() reads its output size back from the device",
    "torch.bincount": "torch.bincount() reads the largest value back from the device",
    "torch.equal": "torch.equal() returns a Python bool: it waits for the device",
    "torch.allclose": "torch.allclose() returns a Python bool: it waits for the device",
}
#: Methods of a device tensor that read it back.
_READBACK_METHODS = {
    "item": ".item() copies the value to the host and waits for it",
    "tolist": ".tolist() copies the tensor to the host and waits for it",
    "cpu": ".cpu() copies the tensor to pageable host memory and waits for it",
    "numpy": ".numpy() needs the tensor on the host",
    "nonzero": ".nonzero() reads its output size back from the device",
    "unique": ".unique() reads its output size back from the device",
    "masked_select": ".masked_select() reads its output size back from the device",
    "bincount": ".bincount() reads the largest value back from the device",
}
#: Methods of a device tensor that return a Python bool.
_BOOL_METHODS = {
    "equal": ".equal() returns a Python bool: it waits for the device",
    "allclose": ".allclose() returns a Python bool: it waits for the device",
}
_SYNC_BUILTINS = {"float", "int", "bool"}
_MASK_CALLS = {"torch.isfinite", "torch.isnan", "torch.isinf", "torch.logical_and",
               "torch.logical_or", "torch.logical_not", "torch.eq", "torch.ne", "torch.gt",
               "torch.lt", "torch.ge", "torch.le"}


def _builtin(model: ModuleModel, call: ast.Call, names) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Name) and f.id in names and f.id not in model.aliases:
        for scope in scope_chain(call):
            if binds_param(scope, f.id):
                return None
        return f.id
    return None


def _is_mask(model: ModuleModel, expr: ast.AST, depth: int = 0) -> bool:
    """True when ``expr`` is a boolean device tensor: a comparison of a
    device tensor, ``torch.isfinite(...)``-like, ``.bool()``, ``~mask``, or
    a name assigned only from such."""
    if depth > 6:
        return False
    if isinstance(expr, ast.Compare):
        return tensor_kind(model, expr) == DEVICE
    if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.Invert):
        return _is_mask(model, expr.operand, depth + 1)
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, (ast.BitAnd, ast.BitOr)):
        return _is_mask(model, expr.left, depth + 1) or _is_mask(model, expr.right, depth + 1)
    if isinstance(expr, ast.Call):
        if model.resolve(expr.func) in _MASK_CALLS:
            return tensor_kind(model, expr) == DEVICE
        f = expr.func
        if isinstance(f, ast.Attribute) and f.attr == "bool" and not expr.args:
            return tensor_kind(model, f.value) == DEVICE
        return False
    if isinstance(expr, ast.Name):
        for scope in scope_chain(expr):
            if binds_param(scope, expr.id):
                return False
            values = model.assignments(scope).get(expr.id)
            if values:
                return all(not isinstance(v, tuple) and _is_mask(model, v, depth + 1) for v in values)
    return False


def _test_is_device(model: ModuleModel, test: ast.AST) -> bool:
    if isinstance(test, ast.BoolOp):
        return any(_test_is_device(model, v) for v in test.values)
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _test_is_device(model, test.operand)
    if isinstance(test, ast.Compare) and any(
        isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in test.ops
    ):
        return False
    return tensor_kind(model, test) == DEVICE


def sync_reason(model: ModuleModel, node: ast.AST) -> Optional[str]:
    """Why ``node`` makes the host wait for the device, or None."""
    if isinstance(node, (ast.If, ast.While, ast.Assert, ast.IfExp)):
        if _test_is_device(model, node.test):
            kind = type(node).__name__.lower()
            return f"a device tensor as an `{kind}` test reads it back to the host"
        return None
    if isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Load):
        if tensor_kind(model, node.value) == DEVICE and _is_mask(model, node.slice):
            return "boolean-mask indexing reads the mask's count back from the device"
        return None
    if not isinstance(node, ast.Call):
        return None
    name = model.resolve(node.func)
    if name in _SYNC_CALLS:
        if name in ("torch.cuda.synchronize",) or any(tensor_kind(model, a) == DEVICE for a in node.args):
            return _SYNC_CALLS[name]
        return None
    if name == "torch.repeat_interleave" and kwarg(node, "output_size") is None:
        if node.args and tensor_kind(model, node.args[-1] if len(node.args) > 1 else node.args[0]) == DEVICE:
            return "torch.repeat_interleave() without output_size reads its output size back"
        return None
    if name in ("torch.tensor", "torch.as_tensor"):
        dev = kwarg(node, "device")
        if dev is not None and not (isinstance(dev, ast.Constant) and str(dev.value).startswith("cpu")):
            if node.args and tensor_kind(model, node.args[0]) != DEVICE:
                return (f"{name}() of host data with device= copies from pageable memory "
                        "and waits for the copy")
        return None
    b = _builtin(model, node, _SYNC_BUILTINS)
    if b is not None:
        if len(node.args) == 1 and tensor_kind(model, node.args[0]) == DEVICE:
            return f"{b}() of a device tensor reads it back to the host"
        return None
    f = node.func
    if not isinstance(f, ast.Attribute):
        return None
    if f.attr == "synchronize" and not node.args and not node.keywords:
        return ".synchronize() blocks the host until the event or stream completes"
    recv = tensor_kind(model, f.value)
    if recv == DEVICE and f.attr in _READBACK_METHODS and not node.args:
        return _READBACK_METHODS[f.attr]
    if recv == DEVICE and f.attr in _BOOL_METHODS:
        return _BOOL_METHODS[f.attr]
    if recv == DEVICE and f.attr == "repeat_interleave" and kwarg(node, "output_size") is None:
        return ".repeat_interleave() without output_size reads its output size back"
    if recv == DEVICE and f.attr == "to" and node.args:
        a = node.args[0]
        if isinstance(a, ast.Constant) and isinstance(a.value, str) and a.value.startswith("cpu"):
            return '.to("cpu") copies the tensor to pageable host memory and waits for it'
    if recv == HOST and f.attr in ("to", "cuda") and not is_true(kwarg(node, "non_blocking")):
        if f.attr == "cuda" or tensor_kind(model, node) == DEVICE:
            return (f".{f.attr}() of a host tensor copies from pageable memory and waits "
                    "for the copy (pin it and pass non_blocking=True)")
    return None


def _nodes(root) -> Iterator[ast.AST]:
    """What runs each time ``root`` runs, not descending into nested
    definitions: a function's body, or a loop's body and ``else`` (and a
    ``while``'s test; a ``for``'s ``iter`` runs once)."""
    if isinstance(root, FUNCTION_NODES):
        yield from iter_body(root)
        return
    parts = list(root.body) + list(root.orelse)
    if isinstance(root, ast.While):
        yield root  # its own test, when it is a device tensor
        parts.append(root.test)
    for part in parts:
        yield part
        yield from iter_body(part)


class _Reach:
    """Launch and sync reach over the project's resolvable calls."""

    def __init__(self, models):
        self.index = FunctionIndex(models)
        self._launches: dict = {}

    def launch(self, model, root, seen=frozenset()) -> Optional[str]:
        """A display name of a launch that ``root`` (a loop or a function)
        makes, directly or through resolvable calls; None without one."""
        if root in self._launches:
            return self._launches[root]
        found = None
        for call in (n for n in _nodes(root) if isinstance(n, ast.Call)):
            info = model.launch_info_for_call(call)
            if info is not None:
                found = info.binding
                break
            target = self.index.resolve(model, call)
            if target is not None and target not in seen and target is not root:
                sub = self.launch(self.index.model_of[target], target, seen | {root})
                if sub is not None:
                    found = f"{target.name}() -> {sub}"
                    break
        if isinstance(root, FUNCTION_NODES):
            self._launches[root] = found
        return found

    def syncs(self, model, root, chain=(), seen=None) -> Iterator[tuple]:
        """``(model, node, reason, chain)`` for every sync that ``root``
        runs itself or through the functions it reaches."""
        seen = set() if seen is None else seen
        seen.add(root)
        for node in _nodes(root):
            reason = sync_reason(model, node)
            if reason is not None:
                yield model, node, reason, chain
            if isinstance(node, ast.Call):
                target = self.index.resolve(model, node)
                if target is not None and target not in seen:
                    yield from self.syncs(self.index.model_of[target], target,
                                          chain + (f"{target.name}()",), seen)


@register
class HostSyncInHotLoop(Rule):
    id = "R003"
    name = "host-sync-in-hot-loop"
    description = (
        "a loop that enqueues device work, or a step method, makes the host "
        "wait for the device (.item(), .cpu(), float(), a tensor test, "
        "nonzero, a pageable copy, synchronize), serializing host and device "
        "per iteration"
    )
    scope = "project"

    def check(self, model: ModuleModel) -> Iterator[Finding]:
        yield from self.check_project([model])

    def check_project(self, models) -> Iterator[Finding]:
        reach = _Reach(models)
        reported: set = set()
        for model in models:
            for root, where, launch in self._roots(model, reach):
                for m, node, reason, chain in reach.syncs(model, root):
                    if id(node) in reported:
                        continue
                    reported.add(id(node))
                    via = f" through {' -> '.join(chain)}" if chain else ""
                    yield self.finding(
                        m,
                        node,
                        f"host sync {where}{via} (which launches `{launch}`): "
                        f"{reason}. Defer the read past the loop (collect device "
                        "values, read them once per epoch) to keep the device "
                        "queue full",
                    )

    @staticmethod
    def _roots(model, reach) -> Iterator[tuple]:
        """(root, where, launch) of every hot loop and step method."""
        for node in ast.walk(model.tree):
            if isinstance(node, LOOP_NODES):
                launch = reach.launch(model, node)
                if launch:
                    yield node, f"in the hot loop at {model.path}:{node.lineno}", launch
            elif (
                isinstance(node, FUNCTION_NODES)
                and LAUNCH_METHOD_RE.match(node.name)
                and enclosing_class(node) is not None
            ):
                yield node, f"in the step method `{node.name}` (run once per step)", node.name
