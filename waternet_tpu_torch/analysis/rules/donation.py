"""R001 — donation-after-use, retargeted: cross-stream use without ownership.

JAX's bug is reading a buffer after donating it to a step. PyTorch's bug
of the same class is a buffer whose ownership the program hands across
CUDA streams (or between the host and a stream) without telling the
runtime, so that memory is read or reused while other work still uses it:

* **the producer** makes tensors under ``with torch.cuda.stream(s):`` and
  uses them after the block (on another stream) without both a wait
  (``wait_stream``/``wait_event``/``synchronize``) and ``record_stream``
  (without it the caching allocator may hand the memory back to ``s``
  while the other stream still reads it); or returns them with no event
  recorded on ``s`` for the consumer to wait on;
* **the consumer** receives tensors with the event (or stream) that made
  them (``tensors, event = sent``), waits on it, and uses the tensors
  without ``record_stream`` on its own stream;
* **a host buffer behind a** ``non_blocking=True`` **copy** is written
  (or, for a copy to the host, read) before the host waits for the copy
  (``event.synchronize()``, ``stream.synchronize()``,
  ``torch.cuda.synchronize()``): the copy may still be reading or writing
  it.

The sanctioned shape is ``DeviceFeeder.send``/``receive``
(``waternet_tpu_torch/utils/tensor.py``): the worker copies on its own
stream and records an event; the consumer waits on the event and marks
each tensor with ``record_stream``. The replicas' own streams
(``serving/replicas.py``) keep a request's upload, forward and readback
on one stream and need neither.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from waternet_tpu_torch.analysis.core import (
    DEVICE,
    FUNCTION_NODES,
    HOST,
    Finding,
    ModuleModel,
    enclosing,
    flatten_targets,
    is_true,
    iter_body,
    kwarg,
    tensor_kind,
)
from waternet_tpu_torch.analysis.registry import Rule, register

_WAITS = frozenset({"wait_stream", "wait_event"})
_HOST_WAIT = "synchronize"


def _end(node) -> int:
    return getattr(node, "end_lineno", node.lineno)


def _method_calls(fn, attr) -> list:
    return [
        n for n in iter_body(fn)
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) and n.func.attr == attr
    ]


def _recorded(fn, name: str) -> bool:
    """True when ``fn`` calls ``<name>.record_stream(...)``, directly or on
    the target of a loop (or comprehension) over ``name``."""
    aliases = {name}
    for node in iter_body(fn):
        if isinstance(node, (ast.For, ast.comprehension)):
            it = node.iter
            if isinstance(it, ast.Name) and it.id in aliases and isinstance(node.target, ast.Name):
                aliases.add(node.target.id)
    return any(
        isinstance(c.func.value, ast.Name) and c.func.value.id in aliases
        for c in _method_calls(fn, "record_stream")
    )


def _device_valued(model: ModuleModel, value: ast.AST) -> bool:
    if isinstance(value, (ast.ListComp, ast.GeneratorExp)):
        value = value.elt
    elif isinstance(value, (ast.List, ast.Tuple)):
        return any(tensor_kind(model, e) == DEVICE for e in value.elts)
    return tensor_kind(model, value) == DEVICE


def _loads_after(fn, name: str, line: int) -> list:
    return sorted(
        (n for n in iter_body(fn)
         if isinstance(n, ast.Name) and n.id == name and isinstance(n.ctx, ast.Load) and n.lineno > line),
        key=lambda n: (n.lineno, n.col_offset),
    )


@register
class CrossStreamUse(Rule):
    id = "R001"
    name = "donation-after-use"
    description = (
        "a tensor made on a side CUDA stream reaches another stream without "
        "wait + record_stream, or a host buffer behind a non_blocking copy "
        "is touched before the copy is waited on"
    )

    def check(self, model: ModuleModel) -> Iterator[Finding]:
        for fn in ast.walk(model.tree):
            if isinstance(fn, FUNCTION_NODES):
                yield from self._producer(model, fn)
                yield from self._consumer(model, fn)
                yield from self._host_buffers(model, fn)

    # -- tensors made under `with torch.cuda.stream(s)` -------------------

    def _producer(self, model, fn):
        for block in iter_body(fn):
            if not isinstance(block, ast.With):
                continue
            if not any(
                isinstance(i.context_expr, ast.Call)
                and model.resolve(i.context_expr.func) == "torch.cuda.stream"
                for i in block.items
            ):
                continue
            made = {}
            events = set()
            for node in ast.walk(block):
                if isinstance(node, ast.Assign) and _device_valued(model, node.value):
                    for t in node.targets:
                        for leaf in flatten_targets(t):
                            if isinstance(leaf, ast.Name):
                                made.setdefault(leaf.id, node)
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "record"
                    and isinstance(node.func.value, ast.Name)
                ):
                    events.add(node.func.value.id)
            end = _end(block)
            for name, where in made.items():
                uses = _loads_after(fn, name, end)
                if not uses:
                    continue
                ret = enclosing(uses[0], (ast.Return,))
                if ret is not None:
                    returned = {n.id for n in ast.walk(ret) if isinstance(n, ast.Name)}
                    if not (events & returned):
                        yield self.finding(
                            model, uses[0],
                            f"`{name}` is made on a side stream (line {where.lineno}) and "
                            "returned with no event recorded on that stream: the consumer "
                            "cannot wait for it. Record an event in the block and return it",
                        )
                    continue
                waited = any(
                    end < c.lineno <= uses[0].lineno
                    for attr in (*_WAITS, _HOST_WAIT) for c in _method_calls(fn, attr)
                ) or any(
                    end < c.lineno <= uses[0].lineno and model.resolve(c.func) == "torch.cuda.synchronize"
                    for c in iter_body(fn) if isinstance(c, ast.Call)
                )
                if not waited or not _recorded(fn, name):
                    missing = "a wait on the side stream" if not waited else "record_stream"
                    yield self.finding(
                        model, uses[0],
                        f"`{name}` is made on a side stream (line {where.lineno}) and used "
                        f"here, after the block, without {missing}: the read may race the "
                        "side stream's work, or the caching allocator may reuse the memory "
                        "while this stream still reads it",
                    )

    # -- tensors received with the event that made them -------------------

    def _consumer(self, model, fn):
        for call in _method_calls(fn, "wait_event") + _method_calls(fn, "wait_stream"):
            if not call.args or not isinstance(call.args[0], ast.Name):
                continue
            ev = call.args[0].id
            siblings = self._unpacked_with(fn, ev)
            for sib in siblings:
                if _loads_after(fn, sib, _end(call)) and not _recorded(fn, sib):
                    yield self.finding(
                        model, call,
                        f"this stream waits on `{ev}`, which came with `{sib}` from another "
                        f"stream, but `{sib}` is not marked with record_stream: the caching "
                        "allocator may hand its memory back to the producer's stream while "
                        "this one still reads it",
                    )

    @staticmethod
    def _unpacked_with(fn, name: str) -> list:
        for node in iter_body(fn):
            if not isinstance(node, ast.Assign):
                continue
            for t in node.targets:
                if isinstance(t, (ast.Tuple, ast.List)):
                    names = [e.id for e in t.elts if isinstance(e, ast.Name)]
                    if name in names:
                        return [n for n in names if n != name]
        return []

    # -- host buffers behind non_blocking copies --------------------------

    def _host_buffers(self, model, fn):
        for call in iter_body(fn):
            if not (isinstance(call, ast.Call) and is_true(kwarg(call, "non_blocking"))):
                continue
            f = call.func
            if not isinstance(f, ast.Attribute):
                continue
            buf, to_host = None, False
            if f.attr in ("to", "cuda") and isinstance(f.value, ast.Name):
                if tensor_kind(model, f.value) == HOST:
                    buf = f.value.id
            elif f.attr == "copy_" and call.args:
                src = call.args[0]
                if isinstance(f.value, ast.Name) and tensor_kind(model, f.value) == HOST:
                    buf, to_host = f.value.id, True
                elif isinstance(src, ast.Name) and tensor_kind(model, src) == HOST:
                    buf = src.id
            if buf is None:
                continue
            hit = self._touched_before_wait(model, fn, buf, call, to_host)
            if hit is not None:
                what = "read" if to_host else "written"
                yield self.finding(
                    model, hit,
                    f"host buffer `{buf}` is {what} here while the non_blocking copy at line "
                    f"{call.lineno} may still be running: wait on the copy's event (or "
                    "stream) first",
                )

    @staticmethod
    def _touched_before_wait(model, fn, buf, copy, to_host) -> Optional[ast.AST]:
        start = _end(copy)
        waits = [
            c.lineno for c in iter_body(fn)
            if isinstance(c, ast.Call) and c.lineno > start and (
                (isinstance(c.func, ast.Attribute) and c.func.attr == _HOST_WAIT)
                or model.resolve(c.func) == "torch.cuda.synchronize"
            )
        ]
        limit = min(waits) if waits else float("inf")
        for node in sorted(iter_body(fn), key=lambda n: (getattr(n, "lineno", 0), getattr(n, "col_offset", 0))):
            line = getattr(node, "lineno", 0)
            if line <= start or line >= limit:
                continue
            if isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store):
                if isinstance(node.value, ast.Name) and node.value.id == buf:
                    return node
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == buf
                and node.func.attr.endswith("_")
                and not node.func.attr.startswith("_")
            ):
                return node
            if (
                to_host
                and isinstance(node, ast.Name)
                and node.id == buf
                and isinstance(node.ctx, ast.Load)
                and enclosing(node, (ast.Return,)) is None
            ):
                return node
        return None
