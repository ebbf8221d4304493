"""The port's lint CLI: ``python -m waternet_tpu_torch.analysis.cli PATH...``.

The JAX package's ``jaxlint`` CLI with its flags (``--json``, ``--rules``,
``--show-suppressed``, ``--list-rules``, ``--lock-graph``). Exit codes
follow linter convention: 0 clean (suppressed findings are clean), 1
unsuppressed findings, 2 usage or parse error. ``--json`` emits the
machine rendering (``{summary, rules, findings[]}``) on stdout.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

from waternet_tpu_torch.analysis import (
    build_lock_graph,
    lint_models,
    parse_model,
)
from waternet_tpu_torch.analysis.core import collect_py_files
from waternet_tpu_torch.analysis.registry import RULES
from waternet_tpu_torch.analysis.report import render_json, render_text


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m waternet_tpu_torch.analysis.cli",
        description=(
            "Static analysis for PyTorch/CUDA hazards (cross-stream use "
            "without record_stream, global-generator draws, host syncs in "
            "hot loops, rebuilds per request, autograd graph leaks) and "
            "concurrency hazards (guarded-by discipline, lock-order "
            "cycles, blocking under locks, event-loop blocking)."
        ),
    )
    p.add_argument(
        "paths",
        nargs="*",
        help="Python files and/or directories (searched recursively)",
    )
    p.add_argument(
        "--json", action="store_true", help="machine-readable output"
    )
    p.add_argument(
        "--rules",
        type=str,
        default=None,
        metavar="R001,R003",
        help="run only these rules (default: all registered rules)",
    )
    p.add_argument(
        "--show-suppressed",
        action="store_true",
        help="also print suppressed findings in the text rendering",
    )
    p.add_argument(
        "--list-rules", action="store_true", help="print the rule catalogue"
    )
    p.add_argument(
        "--lock-graph",
        action="store_true",
        help="emit the static lock-acquisition graph over the given "
        "paths as DOT (nodes = locks by declaration site, edges = "
        "acquired-while-holding; R102 flags its cycles)",
    )
    return p.parse_args(argv)


def main(argv: Optional[list] = None) -> int:
    args = parse_args(argv)
    if args.list_rules:
        for rid, rule in sorted(RULES.items()):
            print(f"{rid}  {rule.name}: {rule.description}")
        return 0
    if not args.paths:
        print("torchlint: no paths given (see --help)", file=sys.stderr)
        return 2
    rules = None
    if args.rules:
        rules = [r.strip().upper() for r in args.rules.split(",") if r.strip()]
        unknown = [r for r in rules if r not in RULES]
        if unknown:
            print(
                f"torchlint: unknown rule(s): {', '.join(unknown)} "
                f"(known: {', '.join(sorted(RULES))})",
                file=sys.stderr,
            )
            return 2
    try:
        files = collect_py_files(args.paths)
    except FileNotFoundError as err:
        print(str(err), file=sys.stderr)
        return 2
    models = []
    for f in files:
        try:
            models.append(parse_model(f))
        except SyntaxError as err:
            print(f"torchlint: cannot parse {f}: {err}", file=sys.stderr)
            return 2
    if args.lock_graph:
        print(build_lock_graph(models).to_dot())
        return 0
    findings = lint_models(models, rules)
    if args.json:
        print(render_json(findings, len(files)))
    else:
        print(render_text(findings, len(files), args.show_suppressed))
    return 1 if any(not f.suppressed for f in findings) else 0


if __name__ == "__main__":
    sys.exit(main())
