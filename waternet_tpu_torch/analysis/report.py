"""Lint reporting: human text and machine ``--json`` renderings.

Both renderings carry the same facts — per-finding rule/location/message
plus the scan summary — so CI can consume ``--json`` while the terminal
output stays greppable ``path:line:col: R00x message`` lines. The
JAX package's renderings, lifted.
"""

from __future__ import annotations

import json
from typing import Iterable

from waternet_tpu_torch.analysis.core import Finding
from waternet_tpu_torch.analysis.registry import RULES


def summarize(findings: Iterable[Finding], files_scanned: int) -> dict:
    findings = list(findings)
    unsuppressed = [f for f in findings if not f.suppressed]
    suppressed = [f for f in findings if f.suppressed]
    return {
        "files_scanned": files_scanned,
        "findings": len(findings),
        "unsuppressed": len(unsuppressed),
        "suppressed": len(suppressed),
    }


def render_text(
    findings: Iterable[Finding],
    files_scanned: int,
    show_suppressed: bool = False,
) -> str:
    findings = list(findings)
    lines = [
        f.render()
        for f in findings
        if show_suppressed or not f.suppressed
    ]
    s = summarize(findings, files_scanned)
    lines.append(
        f"torchlint: {s['files_scanned']} file(s), "
        f"{s['unsuppressed']} finding(s), {s['suppressed']} suppressed"
    )
    return "\n".join(lines)


def render_json(findings: Iterable[Finding], files_scanned: int) -> str:
    findings = list(findings)
    payload = {
        "summary": summarize(findings, files_scanned),
        "rules": {
            rid: {"name": rule.name, "description": rule.description}
            for rid, rule in sorted(RULES.items())
        },
        "findings": [f.as_dict() for f in findings],
    }
    return json.dumps(payload, indent=2)
