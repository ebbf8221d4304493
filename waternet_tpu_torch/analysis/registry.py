"""Rule registry: rules self-register at import; the driver runs them.

The JAX package's registry, lifted. A rule is a class with a unique
``id`` (``R00x``), a one-line ``name``,
and a ``check(model)`` generator yielding :class:`~.core.Finding`s for one
:class:`~.core.ModuleModel`. Registration is a decorator so adding a rule
is one module with one class — the CLI, the tier-1 repo gate, and the docs
table all pick it up from here.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, Optional

from waternet_tpu_torch.analysis.core import Finding, ModuleModel

RULES: Dict[str, "Rule"] = {}


class Rule:
    id: str = ""
    name: str = ""
    description: str = ""
    #: "module" rules see one file at a time; "project" rules (R003, R102) see
    #: every scanned module at once via ``check_project``.
    scope: str = "module"

    def check(self, model: ModuleModel) -> Iterator[Finding]:
        raise NotImplementedError

    def check_project(self, models) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, model: ModuleModel, node, message: str) -> Finding:
        return Finding(
            rule=self.id,
            path=model.path,
            line=getattr(node, "lineno", 0),
            col=getattr(node, "col_offset", 0),
            message=message,
        )


def register(cls):
    rule = cls()
    if not rule.id:
        raise ValueError(f"rule {cls.__name__} has no id")
    if rule.id in RULES:
        raise ValueError(f"duplicate rule id {rule.id}")
    RULES[rule.id] = rule
    return cls


def run_rules(
    model: ModuleModel, rule_ids: Optional[Iterable[str]] = None
) -> list:
    """All module-scope findings for one module, sorted by location."""
    ids = sorted(RULES) if rule_ids is None else list(rule_ids)
    findings = []
    for rid in ids:
        rule = RULES.get(rid)
        if rule is None:
            raise KeyError(f"unknown lint rule: {rid}")
        if rule.scope != "module":
            continue
        findings.extend(rule.check(model))
    findings.sort(key=lambda f: (f.line, f.col, f.rule))
    return findings


def run_project_rules(
    models, rule_ids: Optional[Iterable[str]] = None
) -> list:
    """All project-scope findings over a set of modules (the cross-module
    pass R102 needs: lock-order cycles only exist across files)."""
    ids = sorted(RULES) if rule_ids is None else list(rule_ids)
    findings = []
    for rid in ids:
        rule = RULES.get(rid)
        if rule is None:
            raise KeyError(f"unknown lint rule: {rid}")
        if rule.scope != "project":
            continue
        findings.extend(rule.check_project(models))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings
