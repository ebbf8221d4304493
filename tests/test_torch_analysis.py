"""The port's static analyzer and lock watchdog (``waternet_tpu_torch/
analysis``), on the CPU.

Every rule fires on its positive fixture and stays silent on its negative
one; a suppressed fixture is counted, not reported. The R0xx fixtures
(``tests/fixtures/torchlint``) hold the PyTorch hazards of the retargeted
family; the R1xx and R2xx rules are the JAX package's, lifted, so they run
on its fixtures (``tests/fixtures/threadlint``, ``asynclint``) and must
report the same (rule, line) as its analyzer there and over the port,
except where the torch entries of the R103/R201 blocking lists add a
finding (:data:`TORCH_ONLY`). The two acceptance pins edit a copy of the
real source text in memory, never the file: without the ``record_stream``
loop of ``DeviceFeeder.receive`` R001 fires; with a ``float()`` of the
loss in the dispatch loop of ``_drive_train_epoch`` R003 fires.
"""

import ast
import json
import random
import re
import threading
from pathlib import Path

import pytest

import waternet_tpu.analysis as jax_analysis
from waternet_tpu.analysis.locktrace import LockTracer as JaxLockTracer
import waternet_tpu_torch.analysis as port
from waternet_tpu_torch.analysis import lint_all
from waternet_tpu_torch.analysis.cli import main as cli_main
from waternet_tpu_torch.analysis.core import HOST, tensor_kind
from waternet_tpu_torch.analysis.locktrace import LockTracer
from waternet_tpu_torch.analysis.rules.hostsync import sync_reason

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures"
SEED = 0
R0 = ["R001", "R002", "R003", "R004", "R005"]
R1 = ["R101", "R102", "R103", "R104", "R105"]
R2 = ["R201", "R202", "R203", "R204", "R205"]
#: (fixture, rule, line) that only the port reports: the torch entries of
#: the R103 and R201 blocking lists.
TORCH_ONLY = {
    ("r103_torch_pos.py", "R103", 12),  # torch.cuda.synchronize() under a lock
    ("r103_torch_pos.py", "R103", 17),  # Event.synchronize() under a lock
    ("r103_torch_pos.py", "R103", 22),  # .item() of a device tensor under a lock
    ("r201_torch_pos.py", "R201", 7),  # torch.cuda.synchronize() in a coroutine
    ("r201_torch_pos.py", "R201", 8),  # .cpu() of a device tensor in a coroutine
    ("r201_torch_pos.py", "R201", 12),  # Event.synchronize() in a coroutine
}


def _fixture(rule: str, kind: str) -> Path:
    family = {"0": "torchlint", "1": "threadlint", "2": "asynclint"}[rule[1]]
    return FIXTURES / family / f"{rule.lower()}_{kind}.py"


def test_registry_has_the_fifteen_rules():
    assert sorted(port.RULES) == R0 + R1 + R2
    assert sorted(port.RULES) == sorted(jax_analysis.RULES)
    for rid, rule in port.RULES.items():
        assert rule.name == jax_analysis.RULES[rid].name and rule.description


@pytest.mark.parametrize("rule", R0 + R1 + R2)
def test_rule_fires_on_positive_fixture(rule):
    findings = port.lint_file(_fixture(rule, "pos"))
    assert {f.rule for f in findings if not f.suppressed} == {rule}, [f.render() for f in findings]
    assert len(findings) >= 2


@pytest.mark.parametrize("rule", R0 + R1 + R2)
def test_rule_quiet_on_negative_fixture(rule):
    findings = port.lint_file(_fixture(rule, "neg"))
    assert findings == [], "\n".join(f.render() for f in findings)


def _suppressed_source(rule: str) -> tuple:
    """(path, source) of the rule's suppressed fixture: a file of its own
    for R0xx, else the positive fixture with a written reason on each of
    its findings' lines."""
    if rule in R0:
        path = _fixture(rule, "suppressed")
        return path, path.read_text()
    path = _fixture(rule, "pos")
    lines = path.read_text().split("\n")
    for f in port.lint_file(path):
        lines[f.line - 1] += f"  # jaxlint: disable={rule} deliberate in this fixture"
    return path, "\n".join(lines)


@pytest.mark.parametrize("rule", R0 + R1 + R2)
def test_suppressed_fixture_is_counted_not_reported(rule):
    path, source = _suppressed_source(rule)
    findings = port.lint_source(source, str(path))
    assert findings and all(f.suppressed for f in findings), [f.render() for f in findings]
    assert {f.rule for f in findings} == {rule}


@pytest.mark.parametrize("name,rule", [("r103_torch_pos.py", "R103"), ("r201_torch_pos.py", "R201")])
def test_torch_blocking_entries_fire(name, rule):
    findings = port.lint_file(FIXTURES / "torchlint" / name)
    got = {(name, f.rule, f.line) for f in findings}
    assert got == {t for t in TORCH_ONLY if t[0] == name}


# -- parity with the JAX package's analyzer -----------------------------------


def _r12(mod, paths) -> set:
    files = mod.collect_py_files(paths)
    models = [mod.parse_model(f) for f in files]
    return {(Path(f.path).name, f.rule, f.line) for f in mod.lint_models(models, R1 + R2)}


@pytest.mark.parametrize("target", [
    *(f"threadlint/{p.name}" for p in sorted((FIXTURES / "threadlint").glob("*.py"))),
    *(f"asynclint/{p.name}" for p in sorted((FIXTURES / "asynclint").glob("*.py"))),
    "torchlint/r103_torch_pos.py",
    "torchlint/r201_torch_pos.py",
])
def test_r1xx_r2xx_match_the_jax_analyzer_on_fixtures(target):
    paths = [FIXTURES / target]
    jax_found, port_found = _r12(jax_analysis, paths), _r12(port, paths)
    assert port_found - jax_found == {t for t in TORCH_ONLY if t[0] == Path(target).name}
    assert jax_found - port_found == set()


def test_r1xx_r2xx_match_the_jax_analyzer_over_the_port():
    paths = [REPO / "waternet_tpu_torch"]
    jax_found, port_found = _r12(jax_analysis, paths), _r12(port, paths)
    assert port_found == jax_found
    assert len(port_found) >= 7  # the port's written R101 and R201 suppressions


def test_locktracer_matches_the_jax_tracer():
    """The same seeded two-thread inversion gives the same cycle, by
    creation sites, from both packages' tracers."""

    def inversion(tracer_cls):
        tracer = tracer_cls()
        tracer.install()
        try:
            lock_a = threading.Lock()
            lock_b = threading.RLock()
            first, second = random.Random(SEED).sample([lock_a, lock_b], 2)

            def forward():
                with first:
                    with second:
                        pass

            def backward():
                with second:
                    with first:
                        pass

            for target in (forward, backward):
                t = threading.Thread(target=target)
                t.start()
                t.join()
        finally:
            tracer.uninstall()
        return tracer

    jax_t, port_t = inversion(JaxLockTracer), inversion(LockTracer)
    here = {s for s in port_t.sites if s.startswith(__file__)}
    assert len(here) == 2 and here == {s for s in jax_t.sites if s.startswith(__file__)}
    assert {e for e in port_t.edges if set(e) <= here} == {e for e in jax_t.edges if set(e) <= here}
    cyc = port_t.cycle()
    assert cyc is not None and cyc == jax_t.cycle()
    assert set(cyc) == here
    with pytest.raises(AssertionError, match="lock-order cycle"):
        port_t.assert_acyclic()


# -- the acceptance pins --------------------------------------------------------


def test_r001_pin_fires_when_record_stream_is_removed():
    path = REPO / "waternet_tpu_torch" / "utils" / "tensor.py"
    source = path.read_text()
    assert not [f for f in port.lint_source(source, str(path), ["R001"]) if not f.suppressed]
    loop = re.search(r"\n( +)for t in tensors:\n +t\.record_stream\(stream\)\n", source)
    assert loop is not None, "DeviceFeeder.receive no longer has its record_stream loop"
    reverted = source.replace(loop.group(0), "\n")
    findings = port.lint_source(reverted, str(path), ["R001"])
    wait_line = reverted.split("\n").index(
        next(ln for ln in reverted.split("\n") if "stream.wait_event(event)" in ln)) + 1
    assert [(f.rule, f.line) for f in findings] == [("R001", wait_line)]
    assert "record_stream" in findings[0].message


def test_r003_pin_fires_on_a_float_in_the_dispatch_loop():
    path = REPO / "waternet_tpu_torch" / "training" / "trainer.py"
    source = path.read_text()
    anchor = "            metrics = dispatch(count, payload)\n"
    assert source.count(anchor) == 1, "_drive_train_epoch's dispatch line moved"
    edited = source.replace(anchor, anchor + '            float(metrics["loss"])\n')
    line = edited.split("\n").index('            float(metrics["loss"])') + 1
    before = {(f.line, f.suppressed) for f in port.lint_source(source, str(path), ["R003"])}
    after = port.lint_source(edited, str(path), ["R003"])
    new = [f for f in after if not f.suppressed]
    assert [f.line for f in new] == [line], [f.render() for f in after]
    assert "float() of a device tensor" in new[0].message
    assert all(s for _, s in before)


def test_r003_sees_the_sentinel_window_fetch_through_verify():
    """The sentinel's window fetch is a deliberate sync inside the dispatch
    loop: R003 reaches it through the nested ``verify`` and reports it,
    suppressed with its written reason."""
    path = REPO / "waternet_tpu_torch" / "training" / "trainer.py"
    source = path.read_text()
    findings = port.lint_source(source, str(path), ["R003"])
    fetch = [f for f in findings if "verify() -> _fetch_floats()" in f.message]
    assert len(fetch) == 1 and fetch[0].suppressed
    assert ".cpu()" in source.split("\n")[fetch[0].line - 1]


# -- NumPy look-alikes ----------------------------------------------------------


@pytest.mark.parametrize("rel,needle", [
    ("waternet_tpu_torch/ops/kernels.py", "change.tolist()"),
    ("waternet_tpu_torch/models/quant.py", 'torch.as_tensor(layer["weight"]).detach().cpu()'),
    ("waternet_tpu_torch/models/quant.py", 'torch.as_tensor(layer["bias"]).detach().cpu()'),
    ("waternet_tpu_torch/train.py", "state_dict[k].detach().cpu().contiguous().numpy()"),
])
def test_numpy_lookalikes_are_no_sync(rel, needle):
    """``.tolist()``/``.cpu()``/``.numpy()`` whose receiver resolves to
    numpy, to a host tensor, or to nothing known are no device sync."""
    path = REPO / rel
    model = port.parse_model(path)
    lines = [i + 1 for i, ln in enumerate(model.source.split("\n")) if needle in ln]
    assert lines, f"{needle!r} is gone from {rel}"
    calls = [n for n in ast.walk(model.tree)
             if isinstance(n, ast.Call) and n.lineno in lines
             and isinstance(n.func, ast.Attribute) and n.func.attr in ("tolist", "cpu", "numpy")]
    assert calls
    for call in calls:
        assert sync_reason(model, call) is None, ast.unparse(call)
    if "as_tensor" in needle:
        cpu = next(c for c in calls if c.func.attr == "cpu")
        assert tensor_kind(model, cpu) == HOST


# -- purity, CLI, runner --------------------------------------------------------


@pytest.mark.parametrize("path", sorted((REPO / "waternet_tpu_torch" / "analysis").rglob("*.py")),
                         ids=lambda p: p.name)
def test_analysis_module_imports_no_jax_no_torch(path):
    banned = ("jax", "jaxlib", "waternet_tpu", "torch")
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names = [node.module]
        for name in names:
            assert name.split(".")[0] not in banned, f"{path.name} imports {name}"


def test_cli_exit_codes_and_json(capsys, tmp_path):
    assert cli_main([str(_fixture("R003", "neg"))]) == 0
    capsys.readouterr()
    assert cli_main([str(_fixture("R003", "pos")), "--json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert set(doc) == {"summary", "rules", "findings"}
    assert doc["summary"]["unsuppressed"] == len(doc["findings"]) >= 2
    assert set(doc["findings"][0]) == {"rule", "path", "line", "col", "message", "suppressed"}
    assert cli_main([str(_fixture("R003", "pos")), "--rules", "R001"]) == 0
    assert cli_main([str(_fixture("R003", "pos")), "--rules", "R999"]) == 2
    bad = tmp_path / "bad.py"
    bad.write_text("def broken(:\n")
    assert cli_main([str(bad)]) == 2
    assert cli_main([]) == 2
    capsys.readouterr()
    assert cli_main(["--list-rules"]) == 0
    listing = capsys.readouterr().out
    assert all(r in listing for r in R0 + R1 + R2)
    assert cli_main([str(FIXTURES / "threadlint" / "r102_pos.py"), "--lock-graph"]) == 0
    assert capsys.readouterr().out.startswith("digraph")


def test_lint_all_families_and_default_targets(capsys, monkeypatch, tmp_path):
    assert lint_all.DEFAULT_TARGETS == ("waternet_tpu_torch", "chip_smoke.py")
    assert lint_all.main([str(_fixture("R002", "pos")), "--json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["summary"]["families"]["torchlint"]["unsuppressed"] >= 2
    assert {doc["rules"][r]["family"] for r in R0} == {"torchlint"}
    monkeypatch.chdir(tmp_path)
    assert lint_all.main([]) == 2  # no default target here
