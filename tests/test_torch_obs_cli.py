"""The port's trace CLI (``python -m waternet_tpu_torch.obs.cli``) against
the JAX package's (``waternet_tpu.obs.cli``), on the CPU: the same trace
file, supervisor artifacts and SLO ledger go into both, and their printed
output and exit codes must be equal, character for character. Mirrors
tests/test_obs.py's CLI tests and tests/test_fleet.py's per-worker replay.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

from waternet_tpu.obs.cli import main as jax_cli
from waternet_tpu_torch.obs.cli import main as port_cli
from waternet_tpu_torch.obs.trace import TraceRecorder

REPO = Path(__file__).resolve().parent.parent


def _both(capsys, argv):
    """(rc, stdout) of the port's CLI and of the JAX CLI on ``argv``."""
    out = []
    for main in (port_cli, jax_cli):
        rc = main(list(argv))
        out.append((rc, capsys.readouterr().out))
    return out


def _toy_trace(tmp_path):
    rec = TraceRecorder(capacity=64)
    rec.enable()
    t = time.perf_counter()
    for i, rid in enumerate(["r-slow", "r-fast"]):
        rec.record_span("queue_wait", "serving", t, t + 0.002 + i * 0.01, args={"request_id": rid})
        rec.record_span("device", "serving", t, t + 0.005, args={"request_id": rid})
        rec.record_span("serve", "serving", t, t + 0.02, args={"request_id": rid, "retries": i})
    rec.record_instant("redispatch", "serving", args={"request_id": "r-slow", "retry": 1, "error": "RuntimeError"})
    path = tmp_path / "trace.json"
    rec.export_chrome(path)
    return path


@pytest.mark.parametrize("slowest", ["1", "2", "5"])
def test_analyze_trace_equals_jax(tmp_path, capsys, slowest):
    path = _toy_trace(tmp_path)
    (rc, out), jax = _both(capsys, [str(path), "--slowest", slowest])
    assert (rc, out) == jax and rc == 0
    assert "per-stage latency (ms):" in out
    # The two requests tie on wall time; r-fast sorts first, so r-slow's
    # re-dispatch hop shows from --slowest 2 on.
    assert ("1 re-dispatch hop(s)" in out) == (slowest != "1")
    assert "span summary: 6 spans, 1 instants" in out and "of capacity 64" in out


def test_missing_trace_and_empty_train_root(tmp_path, capsys):
    assert port_cli([str(tmp_path / "nope.json")]) == 1
    assert "no such trace file" in capsys.readouterr().err
    assert port_cli(["--train-root", str(tmp_path)]) == 1
    assert "no supervisor artifacts" in capsys.readouterr().err


def test_train_timeline_equals_jax(tmp_path, capsys):
    """The supervisor timeline from a report and generation heartbeat
    dirs, with the Chrome export, equal to the JAX CLI's."""
    (tmp_path / "supervisor-report.json").write_text(json.dumps({
        "result": "recovered", "restarts": 1, "recovery_sec": [0.5],
        "generations": [
            {"generation": 0, "trigger": "crash", "duration_sec": 1.0,
             "workers": [{"state": "dead", "exit_code": 1, "first_step": 0, "last_step": 3}]},
            {"generation": 1, "trigger": None, "duration_sec": 2.0,
             "workers": [{"state": "done", "exit_code": 0, "first_step": 3, "last_step": 7}]},
        ],
    }))
    gen0 = tmp_path / "gen-000"
    gen0.mkdir()
    (gen0 / "worker-000.json").write_text(json.dumps({
        "pid": 123, "process_id": 0, "generation": 0, "seq": 5, "step": 3, "epoch": 0, "phase": "train",
        "time": 123.0,
    }))
    exports = [tmp_path / "port.json", tmp_path / "jax.json"]
    outs = []
    for main, export in zip((port_cli, jax_cli), exports):
        assert main(["--train-root", str(tmp_path), "--export", str(export)]) == 0
        outs.append(capsys.readouterr().out.replace(str(export), "<export>"))
    assert outs[0] == outs[1]
    assert "generation 0: trigger=crash" in outs[0] and "last beat: step 3, phase train, seq 5" in outs[0]
    assert json.loads(exports[0].read_text()) == json.loads(exports[1].read_text())


def _ledger_entries():
    entries = []
    for i in range(200):
        entries.append({"t": i * 0.5, "latency_ms": 10.0, "outcome": "ok", "worker": "w0g0"})
        entries.append({"t": i * 0.5 + 0.1, "latency_ms": None if i % 2 else 10.0,
                        "outcome": "errors" if i % 2 else "ok", "worker": "w1g0"})
    return entries


@pytest.mark.parametrize("per_worker", [False, True])
def test_slo_replay_equals_jax_and_attributes_the_sick_worker(tmp_path, capsys, per_worker):
    ledger = tmp_path / "ledger.json"
    ledger.write_text(json.dumps({"ledger": _ledger_entries()}))
    argv = ["slo", str(ledger), "--slo", "error_rate<=0.01,p99_ms<=250"] + (["--per-worker"] if per_worker else [])
    (rc, out), jax = _both(capsys, argv)
    assert (rc, out) == jax and rc == 1  # the sick worker's errors page
    if per_worker:
        assert "[worker w0g0]" in out and "[worker w1g0]" in out and "workers replayed: 2" in out
    healthy = tmp_path / "healthy.json"
    healthy.write_text(json.dumps([e for e in _ledger_entries() if e["worker"] == "w0g0"]))
    (rc, out), jax = _both(capsys, ["slo", str(healthy), "--slo", "error_rate<=0.01", "--per-worker"])
    assert (rc, out) == jax and rc == 0


def test_module_entry_point_runs_without_torch(tmp_path):
    """``python -m waternet_tpu_torch.obs.cli`` analyses a trace and never
    imports torch (it runs on hosts without the card's stack)."""
    path = _toy_trace(tmp_path)
    code = ("import runpy, sys; sys.argv = ['cli', sys.argv[1]]; "
            "sys.modules['torch'] = None; runpy.run_module('waternet_tpu_torch.obs.cli', run_name='__main__')")
    proc = subprocess.run([sys.executable, "-c", code, str(path)], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "per-stage latency (ms):" in proc.stdout
