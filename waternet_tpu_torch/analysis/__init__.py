"""The port's static analyzer and its runtime watchdogs.

The JAX package's ``analysis/`` (docs/LINT.md) for PyTorch and CUDA.
Pure-AST: linting never imports the linted code and imports no torch, so
it runs anywhere (no card, no CUDA build). The rule families keep the JAX
package's ids, flags, exit codes and JSON shape; the R0xx family keeps its
five bug classes, retargeted at PyTorch's hazards:

======  ===============================  ==================================================
R001    donation-after-use               a tensor made on a side stream reaches another
                                         stream without wait + record_stream, or a host
                                         buffer behind a non_blocking copy is touched
                                         before the copy is waited on
R002    rng-key-reuse                    a draw from a global generator (torch.rand*,
                                         Tensor.uniform_/normal_, np.random.<fn>, nn.init)
                                         or torch.manual_seed outside torch.random.fork_rng
R003    host-sync-in-hot-loop            .item()/.cpu()/float()/a tensor test/nonzero/a
                                         pageable copy/synchronize in a loop that launches
                                         device work, or in a step method
R004    recompile-hazard                 torch.compile/export/jit, the kernel loader or a
                                         CUDA graph capture rebuilt in a loop or per
                                         request; cudnn.benchmark switched on
R005    tracer-leak                      a tensor with autograd history (a forward's
                                         output, a loss) stored into self/globals/
                                         nonlocals/a container that outlives the step
R101    unguarded-shared-mutation        `# guarded-by:` attr written outside its lock
R102    lock-order-inversion             cycle in the whole-repo lock-acquisition graph
R103    blocking-call-under-lock         result()/join()/get()/sleep/a device sync under a
                                         lock (torch.cuda.synchronize, .synchronize(),
                                         .item()/.cpu()/.tolist()/.numpy() of a tensor)
R104    condition-wait-without-predicate Condition.wait() not re-checked in a while loop
R105    unjoined-thread                  non-daemon Thread started with no join/leak guard
R201    blocking-call-in-coroutine       blocking work (a device sync included) reachable
                                         from a coroutine, no executor
R202    fire-and-forget-task             unretained create_task / bare unawaited coroutine call
R203    cross-thread-loop-access         non-threadsafe loop/future calls from off-loop code
R204    await-under-threading-lock       await while lexically holding a threading.* lock
R205    swallowed-cancellation           CancelledError caught in a coroutine, not re-raised
======  ===============================  ==================================================

Suppress a deliberate pattern with ``# jaxlint: disable=R00x <why>`` on
the line (or ``disable-next=`` on the line above). The comment keeps the
JAX package's name so that one written reason serves both analyzers that
read the port (see :mod:`~waternet_tpu_torch.analysis.core`).

Run it::

    python -m waternet_tpu_torch.analysis.lint_all          # the port + chip_smoke.py
    python -m waternet_tpu_torch.analysis.cli PATH... [--json] [--rules R003]
    python -m waternet_tpu_torch.analysis.cli PATH... --lock-graph   # DOT

Exit codes: 0 clean (suppressed findings are clean), 1 unsuppressed
findings, 2 usage or parse error. The runtime companions are
:mod:`~waternet_tpu_torch.analysis.locktrace` (of R102) and
:mod:`~waternet_tpu_torch.analysis.looptrace` (of R201); R003's is
``torch.cuda.set_sync_debug_mode``, which ``chip_smoke.py`` holds against
this rule on the card.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterable, Optional

from waternet_tpu_torch.analysis.concurrency import (  # noqa: F401
    LockGraph,
    build_lock_graph,
)
from waternet_tpu_torch.analysis.core import (  # noqa: F401
    Finding,
    ModuleModel,
    collect_py_files,
    is_suppressed,
    link_project,
    suppressions,
)
from waternet_tpu_torch.analysis.registry import (  # noqa: F401
    RULES,
    run_project_rules,
    run_rules,
)
import waternet_tpu_torch.analysis.rules  # noqa: F401  (registers the rules)


def parse_model(path) -> ModuleModel:
    """Parse one file into a :class:`ModuleModel` (raises SyntaxError)."""
    source = Path(path).read_text(encoding="utf-8")
    tree = ast.parse(source, filename=str(path))
    return ModuleModel(str(path), source, tree)


def lint_models(models, rules: Optional[Iterable[str]] = None) -> list:
    """Module rules per model, then the project rules over all of them,
    with per-file suppression state resolved."""
    link_project(models)
    findings = []
    for model in models:
        findings.extend(run_rules(model, rules))
    findings.extend(run_project_rules(models, rules))
    supp_by_path = {m.path: suppressions(m.source) for m in models}
    for f in findings:
        f.suppressed = is_suppressed(f, supp_by_path.get(f.path, {}))
    return findings


def lint_source(
    source: str,
    path: str = "<string>",
    rules: Optional[Iterable[str]] = None,
) -> list:
    """Lint one module's source text; returns findings with suppression
    state resolved (project rules run over the one-module project).
    Raises ``SyntaxError`` when the source doesn't parse (the CLI maps
    that to exit code 2)."""
    tree = ast.parse(source, filename=str(path))
    model = ModuleModel(path, source, tree)
    findings = lint_models([model], rules)
    findings.sort(key=lambda f: (f.line, f.col, f.rule))
    return findings


def lint_file(path, rules: Optional[Iterable[str]] = None) -> list:
    return lint_source(
        Path(path).read_text(encoding="utf-8"), str(path), rules
    )


def lint_paths(paths: Iterable, rules: Optional[Iterable[str]] = None):
    """Lint files/directories as ONE project (R003 and R102 see the whole
    set); returns ``(findings, files_scanned)``."""
    files = collect_py_files(paths)
    models = [parse_model(f) for f in files]
    return lint_models(models, rules), len(files)
