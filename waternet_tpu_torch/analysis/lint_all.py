"""All three rule families over the port in one pass:
``python -m waternet_tpu_torch.analysis.lint_all [PATH...] [--json]``.

The JAX package's ``torchlint`` runner: one scan, one merged report
with a per-family breakdown, one exit code. With no paths it scans the
port's lint surface, ``waternet_tpu_torch/`` and ``chip_smoke.py``,
resolved against the current directory (run it from the repository root).

Families are rule-id bands on the shared registry:

======  ==========  ==================================================
R0xx    torchlint   PyTorch/CUDA hazards (cross-stream use, global
                    generator draws, host syncs, rebuilds per request,
                    autograd graph leaks)
R1xx    threadlint  thread hazards (guarded-by, lock order, blocking
                    under locks, condition waits, unjoined threads)
R2xx    asynclint   event-loop hazards (blocking in coroutines,
                    fire-and-forget tasks, cross-thread loop access,
                    await under threading locks, swallowed cancel)
======  ==========  ==================================================

Exit codes follow linter convention: 0 clean (suppressed findings are
clean), 1 unsuppressed findings, 2 usage or parse error. ``--json``
emits the machine rendering with the family breakdown folded into the
summary.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional

from waternet_tpu_torch.analysis import lint_models, parse_model
from waternet_tpu_torch.analysis.core import collect_py_files
from waternet_tpu_torch.analysis.registry import RULES
from waternet_tpu_torch.analysis.report import summarize

#: The port's lint surface: the package and the card's smoke script.
DEFAULT_TARGETS = (
    "waternet_tpu_torch",
    "chip_smoke.py",
)

_FAMILIES = (("R0", "torchlint"), ("R1", "threadlint"), ("R2", "asynclint"))


def family_of(rule_id: str) -> str:
    for prefix, name in _FAMILIES:
        if rule_id.startswith(prefix):
            return name
    return "other"


def family_summary(findings) -> dict:
    """``{family: {"findings": n, "unsuppressed": n}}`` for every family
    that has at least one registered rule (zeroes included, so a family
    going silent is visible in CI diffs)."""
    out = {
        name: {"findings": 0, "unsuppressed": 0}
        for _prefix, name in _FAMILIES
        if any(family_of(rid) == name for rid in RULES)
    }
    for f in findings:
        fam = out.setdefault(
            family_of(f.rule), {"findings": 0, "unsuppressed": 0}
        )
        fam["findings"] += 1
        if not f.suppressed:
            fam["unsuppressed"] += 1
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m waternet_tpu_torch.analysis.lint_all",
        description=(
            "Run every rule family (torchlint R0xx, threadlint R1xx, "
            "asynclint R2xx) over the port's lint surface in one pass "
            "with a merged report and a single exit code."
        ),
    )
    p.add_argument(
        "paths",
        nargs="*",
        help=(
            "Python files and/or directories; default is the port's lint "
            f"surface ({', '.join(DEFAULT_TARGETS)}) resolved against "
            "the current directory"
        ),
    )
    p.add_argument(
        "--json", action="store_true", help="machine-readable output"
    )
    p.add_argument(
        "--rules",
        type=str,
        default=None,
        metavar="R201,R102",
        help="run only these rules (default: all registered rules)",
    )
    p.add_argument(
        "--show-suppressed",
        action="store_true",
        help="also print suppressed findings in the text rendering",
    )
    p.add_argument(
        "--list-rules",
        action="store_true",
        help="print the rule catalogue grouped by family",
    )
    return p.parse_args(argv)


def main(argv: Optional[list] = None) -> int:
    args = parse_args(argv)
    if args.list_rules:
        current = None
        for rid, rule in sorted(RULES.items()):
            fam = family_of(rid)
            if fam != current:
                print(f"[{fam}]")
                current = fam
            print(f"{rid}  {rule.name}: {rule.description}")
        return 0

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

    paths = args.paths
    if not paths:
        paths = [t for t in DEFAULT_TARGETS if Path(t).exists()]
        if not paths:
            print(
                "torchlint: none of the default targets exist here "
                "(run from the repo root or pass paths)",
                file=sys.stderr,
            )
            return 2
    try:
        files = collect_py_files(paths)
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

    findings = lint_models(models, rules)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    summary = summarize(findings, len(files))
    summary["families"] = family_summary(findings)

    if args.json:
        payload = {
            "summary": summary,
            "rules": {
                rid: {
                    "family": family_of(rid),
                    "name": rule.name,
                    "description": rule.description,
                }
                for rid, rule in sorted(RULES.items())
            },
            "findings": [f.as_dict() for f in findings],
        }
        print(json.dumps(payload, indent=2))
    else:
        for f in findings:
            if args.show_suppressed or not f.suppressed:
                print(f.render())
        for name, fam in summary["families"].items():
            print(
                f"torchlint [{name}]: {fam['unsuppressed']} finding(s), "
                f"{fam['findings'] - fam['unsuppressed']} suppressed"
            )
        print(
            f"torchlint: {summary['files_scanned']} file(s), "
            f"{summary['unsuppressed']} finding(s), "
            f"{summary['suppressed']} suppressed"
        )
    return 1 if summary["unsuppressed"] else 0


if __name__ == "__main__":
    sys.exit(main())
