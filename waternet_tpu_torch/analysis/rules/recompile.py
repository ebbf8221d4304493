"""R004 — recompile-hazard, retargeted: a rebuild in a loop or per request.

Compiling, tracing, exporting, capturing a CUDA graph and building the
CUDA kernels are the most expensive host-side events the port has, each
seconds to minutes. Done once at start-up they are free; done inside a
loop or on a path that runs per request, they are paid again on every
iteration and erase every throughput number the benches report. The
rule flags, lexically inside a ``for``/``while`` body or in a per-request
function (a coroutine — the front door's handlers —, a ``forward``, a
step method ``train_step*``/``eval_step*``):

* ``torch.compile``, ``torch.export.export``, ``torch.jit.trace``/
  ``script``/``trace_module``;
* ``torch.utils.cpp_extension.load``/``load_inline`` and the port's own
  kernel loader (``waternet_tpu_torch.ops._build.load``/``build``);
* ``torch.cuda.CUDAGraph()`` and ``torch.cuda.graph(...)`` capture, and
  ``torch.cuda.make_graphed_callables``.

It also flags ``torch.backends.cudnn.benchmark = True`` anywhere: the
autotuner then re-plans every convolution for each new input shape, and
the serving path sees per-request shapes. The engine keeps it off on
purpose (``inference_engine.py``).

A loop's ``iter`` (and a ``while``'s test) runs once, or is no rebuild,
and stays exempt, as a rebuild in a nested function that the loop only
defines does.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from waternet_tpu_torch.analysis.core import (
    FUNCTION_NODES,
    LAUNCH_METHOD_RE,
    LOOP_NODES,
    Finding,
    ModuleModel,
    SCOPE_NODES,
    dotted_parts,
    parent,
)
from waternet_tpu_torch.analysis.registry import Rule, register

REBUILDERS = {
    "torch.compile": "torch.compile() compiles the callable anew",
    "torch.export.export": "torch.export.export() traces the program anew",
    "torch.jit.trace": "torch.jit.trace() traces the callable anew",
    "torch.jit.trace_module": "torch.jit.trace_module() traces the module anew",
    "torch.jit.script": "torch.jit.script() compiles the callable anew",
    "torch.utils.cpp_extension.load": "cpp_extension.load() builds (or re-checks) the extension",
    "torch.utils.cpp_extension.load_inline": "cpp_extension.load_inline() builds the extension",
    "waternet_tpu_torch.ops._build.load": "the kernel loader builds or re-checks the CUDA library",
    "waternet_tpu_torch.ops._build.build": "the kernel builder runs nvcc",
    "torch.cuda.CUDAGraph": "a CUDA graph is captured anew",
    "torch.cuda.graph": "a CUDA graph is captured anew",
    "torch.cuda.make_graphed_callables": "make_graphed_callables() captures CUDA graphs anew",
}
_PER_REQUEST_NAMES = ("forward",)


def _per_request(fn) -> bool:
    return (
        isinstance(fn, ast.AsyncFunctionDef)
        or fn.name in _PER_REQUEST_NAMES
        or bool(LAUNCH_METHOD_RE.match(fn.name))
    )


def _where(node: ast.AST) -> Optional[str]:
    """Why ``node`` runs repeatedly: inside a loop body, or in a
    per-request function; None when neither holds in its own scope."""
    cur = node
    while True:
        anc = parent(cur)
        if anc is None:
            return None
        if isinstance(anc, FUNCTION_NODES):
            if _per_request(anc):
                kind = "coroutine" if isinstance(anc, ast.AsyncFunctionDef) else "per-step/per-request"
                return f"in the {kind} function `{anc.name}`"
            return None
        if isinstance(anc, SCOPE_NODES):
            return None
        if isinstance(anc, LOOP_NODES) and cur not in (
            getattr(anc, "iter", None),
            getattr(anc, "test", None),
        ):
            return f"inside the loop at line {anc.lineno}"
        cur = anc


@register
class RecompileHazard(Rule):
    id = "R004"
    name = "recompile-hazard"
    description = (
        "torch.compile/export/jit, the kernel loader or a CUDA graph capture "
        "evaluated in a loop or per request, or cudnn.benchmark switched on"
    )

    def check(self, model: ModuleModel) -> Iterator[Finding]:
        for node in ast.walk(model.tree):
            if isinstance(node, ast.Call):
                name = model.resolve(node.func)
                if name not in REBUILDERS:
                    continue
                where = _where(node)
                if where is None:
                    continue
                yield self.finding(
                    model,
                    node,
                    f"`{name}` {where}: {REBUILDERS[name]} on every pass. "
                    "Build once at start-up (or cache by shape) and reuse it",
                )
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                if not (isinstance(node.value, ast.Constant) and node.value.value is True):
                    continue
                for t in targets:
                    parts = dotted_parts(t)
                    if parts and model.resolve(t) == "torch.backends.cudnn.benchmark":
                        yield self.finding(
                            model,
                            node,
                            "`torch.backends.cudnn.benchmark = True` re-plans every "
                            "convolution for each new input shape: with per-request "
                            "shapes that is a rebuild per request. Keep it off on "
                            "serving paths",
                        )
