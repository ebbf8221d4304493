"""The port's gang supervisor (``resilience/supervisor.py``), as the JAX
package's tests pin it, on the CPU.

* the per-worker health machine and the backoff schedule are pure, held
  against the JAX package's on the same inputs with no processes;
* the restart orchestration (crash -> drain -> backoff -> relaunch with
  ``--resume auto``; a hang found by heartbeat age; a fault aimed at one
  worker of one generation; budget exhaustion -> report + exit 3) runs
  against sub-second stub workers that speak only the env contract;
* one real 2-process gloo job of ``python -m waternet_tpu_torch.train``
  (one intra-op thread a process) killed hard mid-epoch (``proc_kill@3``
  on rank 1, past the step-2 checkpoint) restarts and finishes with CSVs
  and weights byte-identical to an uninterrupted control;
* ``bench --config train_chaos`` at the same size: recovered through a kill
  and a hang, restarts counted, ``exact_resume`` true.

Timeouts: the stub supervisors' hang threshold is 1.2 s only where a hang
is the point; elsewhere 20 s, so a loaded machine cannot fake one.
"""

import dataclasses
import json
import os
import sys
from pathlib import Path

import pytest

from waternet_tpu.resilience import heartbeat as jax_hb
from waternet_tpu.resilience import supervisor as jax_sup
from waternet_tpu_torch.resilience import faults
from waternet_tpu_torch.resilience import heartbeat as hb
from waternet_tpu_torch.resilience.supervisor import (
    EXIT_BUDGET_EXHAUSTED,
    Supervisor,
    SupervisorConfig,
    _parse_fault_arg,
    backoff_sec,
)
from waternet_tpu_torch.resilience.supervisor import main as supervisor_main

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _clear_faults(monkeypatch):
    monkeypatch.delenv("WATERNET_FAULTS", raising=False)
    faults.clear()
    yield
    faults.clear()


# ----------------------------------------------------------------------
# The pure parts, against the JAX package's
# ----------------------------------------------------------------------

# (observe time, exit code or None, beat to note first or None)
SCRIPTS = {
    "freshness": [(1005.0, None, None), (1015.0, None, (1010.0, 5, "train")), (1021.0, None, None),
                  (1041.0, None, None)],
    "late_recovers": [(1025.0, None, (1010.0, 1, "train")), (1027.0, None, (1026.0, 2, "train"))],
    "done_is_terminal": [(1011.0, 0, (1010.0, 1, "train")), (99999.0, None, None)],
    "dead_is_terminal": [(1011.0, 7, None), (99999.0, 0, None)],
    "startup_grace": [(1059.0, None, None), (1060.0, None, None)],
    "startup_beat_arms_no_hang": [(1050.0, None, (1001.0, 0, "startup")), (1099.0, None, None),
                                  (1101.0, None, None)],
    "stale_record": [(1011.0, None, (1010.0, 5, "train")), (1012.0, None, (1004.0, 99, "train"))],
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_worker_health_equals_jax(script):
    grace = 100.0 if script == "startup_beat_arms_no_hang" else 60.0
    ours, theirs = hb.WorkerHealth(10.0, 30.0, grace, 1000.0), jax_hb.WorkerHealth(10.0, 30.0, grace, 1000.0)
    states = []
    for t, rc, beat in SCRIPTS[script]:
        for w in (ours, theirs):
            if beat is not None:
                w.note_beat({"time": beat[0], "step": beat[1], "phase": beat[2]})
        got, want = ours.observe(t, exit_code=rc), theirs.observe(t, exit_code=rc)
        assert got == want
        assert ours.failed == theirs.failed and ours.summary() == theirs.summary()
        states.append(got)
    assert len(set(states)) >= 1


def test_worker_health_rejects_inverted_thresholds():
    with pytest.raises(ValueError):
        hb.WorkerHealth(30.0, 10.0, 60.0, 0.0)


@pytest.mark.parametrize("base,cap,i", [(1.0, 30.0, 1), (1.0, 30.0, 2), (1.0, 30.0, 3), (1.0, 30.0, 10),
                                        (0.0, 0.0, 5), (0.5, 4.0, 0)])
def test_backoff_equals_jax(base, cap, i):
    assert backoff_sec(base, cap, i) == jax_sup.backoff_sec(base, cap, i)


def test_parse_fault_arg_equals_jax():
    for spec in ("0:1:proc_kill@3", "2:0:proc_hang@5,nan@7"):
        assert _parse_fault_arg(spec) == jax_sup._parse_fault_arg(spec)
    with pytest.raises(ValueError):
        _parse_fault_arg("proc_kill@3")


def test_config_defaults_equal_jax():
    ours = dataclasses.asdict(SupervisorConfig())
    theirs = dataclasses.asdict(jax_sup.SupervisorConfig())
    assert ours == theirs and EXIT_BUDGET_EXHAUSTED == jax_sup.EXIT_BUDGET_EXHAUSTED == 3


# ----------------------------------------------------------------------
# Orchestration against stub workers
# ----------------------------------------------------------------------

_STUB = r"""
import json, os, sys, time

rank = int(os.environ["WATERNET_PROCESS_ID"])
gen = int(os.environ["WATERNET_GENERATION"])
hbdir = os.environ["WATERNET_HEARTBEAT_DIR"]


def beat(step, phase="train"):
    path = os.path.join(hbdir, "worker-%03d.json" % rank)
    with open(path + ".tmp", "w") as f:
        json.dump({"pid": os.getpid(), "process_id": rank, "generation": gen,
                   "step": step, "phase": phase, "time": time.time()}, f)
    os.replace(path + ".tmp", path)


contract = {k: v for k, v in os.environ.items() if k.startswith("WATERNET_")}
contract["argv"] = sys.argv[1:]
with open(os.path.join(hbdir, "contract-%d.json" % rank), "w") as f:
    json.dump(contract, f)

beat(1)
if os.environ.get("STUB_FAULT_CRASH") and os.environ.get("WATERNET_FAULTS"):
    sys.exit(21)
if os.environ.get("STUB_CRASH_ALWAYS") and rank == 0:
    sys.exit(9)
crash_gen = os.environ.get("STUB_CRASH_GEN")
if crash_gen is not None and gen == int(crash_gen) \
        and rank == int(os.environ.get("STUB_CRASH_RANK", "0")):
    sys.exit(7)
hang_gen = os.environ.get("STUB_HANG_GEN")
if hang_gen is not None and gen == int(hang_gen) \
        and rank == int(os.environ.get("STUB_HANG_RANK", "0")):
    beat(2)
    time.sleep(600)  # wedged: alive, never beats again
beat(3)
beat(4, phase="done")
"""


def _stub_supervisor(tmp_path, extra_env=None, faults_map=None, **cfg_kw):
    cfg = SupervisorConfig(num_workers=2, max_restarts=2, backoff_base_sec=0.0, backoff_cap_sec=0.0,
                           late_sec=5.0, hang_sec=20.0, startup_grace_sec=60.0, drain_grace_sec=5.0,
                           poll_sec=0.02, heartbeat_sec=0.0)
    cfg = dataclasses.replace(cfg, **cfg_kw)
    env = dict(os.environ)
    env.pop("WATERNET_FAULTS", None)
    env.update(extra_env or {})
    return Supervisor([sys.executable, "-c", _STUB, "--alpha", "1"], tmp_path / "sup", cfg, env=env,
                      faults=faults_map)


def _contract(sup, generation, rank):
    return json.loads((sup.heartbeat_dir / f"gen-{generation:03d}" / f"contract-{rank}.json").read_text())


def test_supervisor_clean_completion_and_env_contract(tmp_path):
    sup = _stub_supervisor(tmp_path, cpu_gloo=True)
    report = sup.run()
    assert report["result"] == "completed" and report["restarts"] == 0
    assert all(w["state"] == hb.DONE for w in report["generations"][0]["workers"])
    for rank in range(2):
        c = _contract(sup, 0, rank)
        host, _, port = c["WATERNET_COORDINATOR"].partition(":")
        assert host == "127.0.0.1" and 0 < int(port) < 65536
        assert (c["WATERNET_NUM_PROCESSES"], c["WATERNET_PROCESS_ID"], c["WATERNET_GENERATION"]) == \
            ("2", str(rank), "0")
        assert c["WATERNET_HEARTBEAT_SEC"] == "0.0" and c["WATERNET_CPU_GLOO"] == "1"
        assert Path(c["WATERNET_HEARTBEAT_DIR"]) == sup.heartbeat_dir / "gen-000"
        assert "WATERNET_FAULTS" not in c and c["argv"] == ["--alpha", "1"]
    assert (sup.heartbeat_dir / "supervisor-report.json").is_file()


def test_supervisor_restarts_after_crash_with_resume_auto(tmp_path):
    sup = _stub_supervisor(tmp_path, extra_env={"STUB_CRASH_GEN": "0", "STUB_CRASH_RANK": "1"})
    report = sup.run()
    assert report["result"] == "completed" and report["restarts"] == 1
    assert "worker 1 exited rc=7" in report["generations"][0]["trigger"]
    c = _contract(sup, 1, 0)
    assert c["argv"] == ["--alpha", "1", "--resume", "auto"] and c["WATERNET_GENERATION"] == "1"
    # Generation 0's rank 1 wrote its contract before it crashed; rank 0 may
    # have been drained before its interpreter got that far.
    assert c["WATERNET_COORDINATOR"] != _contract(sup, 0, 1)["WATERNET_COORDINATOR"]
    assert len(report["recovery_sec"]) == 1 and report["recovery_sec"][0] >= 0.0


def test_supervisor_detects_hang_by_heartbeat_timeout(tmp_path):
    sup = _stub_supervisor(tmp_path, extra_env={"STUB_HANG_GEN": "0", "STUB_HANG_RANK": "0"},
                           late_sec=0.4, hang_sec=1.2)
    report = sup.run()
    assert report["result"] == "completed" and report["restarts"] == 1
    assert "worker 0 presumed hung" in report["generations"][0]["trigger"]
    assert report["generations"][0]["duration_sec"] < 30.0  # not the stub's 600 s sleep


def test_supervisor_fault_injection_targets_one_worker_one_generation(tmp_path):
    sup = _stub_supervisor(tmp_path, extra_env={"STUB_FAULT_CRASH": "1"}, faults_map={(0, 1): "proc_kill@3"})
    report = sup.run()
    assert report["result"] == "completed" and report["restarts"] == 1
    assert _contract(sup, 0, 1)["WATERNET_FAULTS"] == "proc_kill@3"
    # Generation 0's rank 0 may have been drained before it wrote anything.
    for gen, rank in ((1, 0), (1, 1)):
        assert "WATERNET_FAULTS" not in _contract(sup, gen, rank)
    gen0_rank0 = sup.heartbeat_dir / "gen-000" / "contract-0.json"
    assert not gen0_rank0.is_file() or "WATERNET_FAULTS" not in json.loads(gen0_rank0.read_text())


def test_supervisor_budget_exhaustion_is_loud_and_exits_3(tmp_path, capsys):
    sup = _stub_supervisor(tmp_path, extra_env={"STUB_CRASH_ALWAYS": "1"}, max_restarts=1)
    report = sup.run()
    assert report["result"] == "failed" and report["restarts"] == 1 and len(report["generations"]) == 2
    err = capsys.readouterr().err
    assert "RETRY BUDGET EXHAUSTED" in err and "rc=9" in err
    assert json.loads((sup.heartbeat_dir / "supervisor-report.json").read_text())["result"] == "failed"

    script = tmp_path / "stub.py"
    script.write_text(_STUB)
    assert supervisor_main(["--workers", "1", "--heartbeat-dir", str(tmp_path / "ok"), "--backoff-sec", "0",
                            "--worker-cmd", f"{sys.executable} {script}", "--", "--beta", "2"]) == 0
    assert json.loads((tmp_path / "ok" / "gen-000" / "contract-0.json").read_text())["argv"] == ["--beta", "2"]
    os.environ["STUB_CRASH_ALWAYS"] = "1"
    try:
        rc = supervisor_main(["--workers", "1", "--max-restarts", "0", "--backoff-sec", "0",
                              "--heartbeat-dir", str(tmp_path / "bad"), "--worker-cmd", f"{sys.executable} {script}"])
    finally:
        del os.environ["STUB_CRASH_ALWAYS"]
    assert rc == EXIT_BUDGET_EXHAUSTED


# ----------------------------------------------------------------------
# A real 2-process job, killed mid-epoch
# ----------------------------------------------------------------------

TRAIN_ARGS = ["-m", "waternet_tpu_torch.train", "--device", "cpu", "--synthetic", "8", "--batch-size", "4",
              "--height", "32", "--width", "32", "--no-perceptual", "--precision", "fp32", "--epochs", "3",
              "--checkpoint-every", "2", "--workers", "0"]


def _final_run(root: Path) -> Path:
    return max((d for d in root.iterdir() if (d / "metrics-train.csv").is_file()), key=lambda d: int(d.name))


def test_supervised_2proc_kill_midepoch_byte_identical(tmp_path):
    cfg = SupervisorConfig(num_workers=2, max_restarts=2, backoff_base_sec=0.1, backoff_cap_sec=0.5,
                           late_sec=20.0, hang_sec=60.0, startup_grace_sec=300.0, drain_grace_sec=15.0,
                           poll_sec=0.1, heartbeat_sec=0.0, cpu_gloo=True)
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)}
    env.pop("WATERNET_FAULTS", None)

    def run(tag, faults_map):
        root = tmp_path / tag / "training"
        sup = Supervisor([sys.executable, *TRAIN_ARGS, "--train-root", str(root)], tmp_path / tag / "sup", cfg,
                         env=env, faults=faults_map)
        return sup.run(), root

    control, control_root = run("control", {})
    assert control["result"] == "completed" and control["restarts"] == 0
    chaos, chaos_root = run("chaos", {(0, 1): "proc_kill@3"})
    assert chaos["result"] == "completed" and chaos["restarts"] == 1
    trigger = chaos["generations"][0]["trigger"]
    assert "exited" in trigger or "presumed hung" in trigger
    cd, xd = _final_run(control_root), _final_run(chaos_root)
    for name in ("metrics-train.csv", "metrics-val.csv", "last.npz"):
        assert (cd / name).read_bytes() == (xd / name).read_bytes(), name
    config = json.loads((xd / "config.json").read_text())
    assert config["num_processes"] == 2 and config["restart_generation"] == 1


def test_bench_train_chaos_contract_line(tmp_path):
    import torch

    from waternet_tpu_torch import bench

    line = bench.bench_train_chaos(torch.device("cpu"), hang_sec=6.0, job_dir=tmp_path / "job")
    assert line["metric"] == "chaos_train_images_per_sec" and line["value"] > 0
    assert line["workers"] == 2 and line["result"] == "completed" and line["recovered"] is True
    assert line["restarts"] == 2 and line["control_restarts"] == 0 and line["generations"] == 3
    assert line["exact_resume"] is True
    assert line["recovery_sec"] >= 0.0 and line["steps_lost"] >= 0
