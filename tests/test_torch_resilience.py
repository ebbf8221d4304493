"""The port's resilience modules (``waternet_tpu_torch/resilience``, the
``decode@K`` hook of the UIEB loader, ``obs/window`` and ``obs/trace``
under the trainer), held against the JAX package's on the CPU.

``resilience/faults.py`` is lifted whole, so a ``WATERNET_FAULTS`` spec
parses to the same events in both packages, and both refuse the same bad
specs. The checkpoint manager is tested on the JAX tests' cases
(tests/test_resilience.py): retention, unfinalized and staging dirs, a
directory vanishing mid-scan, a missing root, a peer-pruned checkpoint,
the legacy ``state/`` directory and ``--resume auto`` aborting on a config
mismatch; the CLI-level fallback past a truncated checkpoint is in
tests/test_torch_resume.py. Heartbeat records carry the JAX writer's keys;
the windowed perf row and the epoch driver's spans carry the JAX names.
"""

import json
import os
import shutil
import signal
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from waternet_tpu.resilience import faults as jax_faults
from waternet_tpu_torch.data.synthetic import SyntheticPairs
from waternet_tpu_torch.obs import trace
from waternet_tpu_torch.resilience import (
    CheckpointManager,
    DivergenceError,
    DivergenceSentinel,
    EpochControl,
    PreemptionGuard,
    auto_resume,
    faults,
)
from waternet_tpu_torch.resilience.manager import MARKER
from waternet_tpu_torch.training.trainer import CheckpointMismatchError, TrainConfig, TrainingEngine
from waternet_tpu_torch.utils.checkpoint import save_state_atomic
from tests.test_torch_uieb import write_uieb_tree


@pytest.fixture(autouse=True)
def _clear_faults():
    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()


def _engine(**over) -> TrainingEngine:
    kw = dict(batch_size=4, im_height=32, im_width=32, precision="fp32", perceptual_weight=0.0)
    kw.update(over)
    return TrainingEngine(TrainConfig(**kw), device="cpu")


# ----------------------------------------------------------------------
# Fault plans: the same specs, the same events
# ----------------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    "nan@3",
    "nan@3,sigterm@10",
    " decode@1 , decode@2,truncate_ckpt@2 ",
    "proc_kill@5,proc_hang@6",
    "slow_replica@1,replica_crash@2,replica_hang@3,nan_output@4",
    "reject_admit@1,stream_stall@2,stream_disconnect@3,frame_corrupt@4,gateway_crash@5,gateway_hang@6",
])
def test_fault_specs_parse_to_the_same_events(spec):
    got, want = faults.FaultPlan.parse(spec), jax_faults.FaultPlan.parse(spec)
    assert got._pending == want._pending and got._pending
    for kind, at in sorted(want._pending):
        assert got.fire(kind, at) and want.fire(kind, at)
        assert not got.fire(kind, at)  # one-shot
    assert got.fired == want.fired and not got and not want


def test_fault_kinds_are_the_jax_packages():
    assert faults.FaultPlan.KINDS == jax_faults.FaultPlan.KINDS


@pytest.mark.parametrize("spec,needle", [
    ("explode@3", "unknown fault kind"),
    ("nan@2,meltdown@4", "unknown fault kind"),
    ("nan", "needs '@<step>'"),
    ("nan@x", "invalid literal"),
])
def test_bad_fault_specs_are_rejected_by_both(spec, needle):
    for mod in (faults, jax_faults):
        with pytest.raises(ValueError, match=needle):
            mod.FaultPlan.parse(spec)


def test_install_from_env(monkeypatch):
    monkeypatch.setenv("WATERNET_FAULTS", "nan@2,decode@1")
    plan = faults.install_from_env()
    assert plan is faults.active() and plan._pending == {("nan", 2), ("decode", 1)}
    monkeypatch.delenv("WATERNET_FAULTS")
    faults.clear()
    assert faults.install_from_env() is None


def test_nan_fault_poisons_the_parameters_in_place():
    eng = _engine()
    faults.install(faults.FaultPlan.parse("nan@1"))
    m = {"loss": torch.tensor(1.0), "psnr": torch.tensor(2.0)}
    assert faults.after_train_step(eng, m, 2) is m  # not this step
    out = faults.after_train_step(eng, m, 1)
    assert set(out) == set(m) and all(torch.isnan(v) for v in out.values())
    assert all(torch.isnan(p).all() for p in eng.model.parameters())
    assert faults.after_train_step(eng, m, 1) is m  # one-shot


# ----------------------------------------------------------------------
# The checkpoint manager
# ----------------------------------------------------------------------


def _mk_ck(root: Path, step: int, **meta) -> Path:
    d = root / f"step-{step:010d}"
    (d / "state").mkdir(parents=True)
    (d / MARKER).write_text(json.dumps({"step": step, **meta}))
    return d


def test_manager_retention_keeps_last_n_plus_best(tmp_path):
    eng = _engine()
    mgr = CheckpointManager(tmp_path / "ck", keep=2)
    for step, psnr in {1: 10.0, 2: 30.0, 3: 12.0, 4: 11.0, 5: 13.0}.items():
        mgr.save(eng, meta={"step": step, "val_psnr": psnr})
    # The last 2 (steps 4, 5) and the best by PSNR (step 2).
    assert [ck.step for ck in mgr.checkpoints()] == [2, 4, 5]
    assert not list((tmp_path / "ck").glob(".tmp-*"))


def test_manager_resave_of_a_step_replaces_it(tmp_path):
    eng = _engine()
    mgr = CheckpointManager(tmp_path / "ck")
    mgr.save(eng, meta={"step": 3, "batch_index": 1})
    path = mgr.save(eng, meta={"step": 3, "batch_index": 0})
    assert [ck.meta["batch_index"] for ck in mgr.checkpoints()] == [0]
    assert (path / "state" / "state.pt").is_file()


def test_checkpoint_scan_skips_staging_and_junk(tmp_path):
    root = tmp_path / "checkpoints"
    _mk_ck(root, 2)
    _mk_ck(root, 4)
    staging = root / "step-0000000006.tmp"
    staging.mkdir()
    (staging / MARKER).write_text('{"step": 6}')
    (root / "step-0000000008.orbax-checkpoint-tmp-123").mkdir()
    (root / ".tmp-step-0000000009").mkdir()
    (root / "step-junk").mkdir()
    (root / "step-0000000010").write_text("a plain file, not a step dir")
    (root / "step-0000000012").mkdir()  # unfinalized: no marker yet
    assert [ck.step for ck in CheckpointManager(root).checkpoints()] == [2, 4]


def test_checkpoint_scan_tolerates_vanish_mid_scan(tmp_path, monkeypatch):
    import pathlib

    root = tmp_path / "checkpoints"
    _mk_ck(root, 2)
    victim = _mk_ck(root, 4)
    _mk_ck(root, 6)
    real = pathlib.Path.read_text

    def vanishing_read(self, *a, **kw):
        if self == victim / MARKER:
            raise FileNotFoundError(str(self))
        return real(self, *a, **kw)

    monkeypatch.setattr(pathlib.Path, "read_text", vanishing_read)
    assert [ck.step for ck in CheckpointManager(root).checkpoints()] == [2, 6]


def test_checkpoint_scan_missing_root_is_empty(tmp_path):
    assert CheckpointManager(tmp_path / "never-created").checkpoints() == []


def test_restore_latest_good_skips_a_checkpoint_pruned_by_a_peer(tmp_path):
    root = tmp_path / "checkpoints"
    _mk_ck(root, 2)
    shutil.rmtree(_mk_ck(root, 4) / "state")  # the marker remains

    restored = []

    class _Stub:
        def restore(self, path):
            restored.append(Path(path))

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ck = CheckpointManager(root).restore_latest_good(_Stub())
    assert ck.step == 2 and restored == [root / "step-0000000002" / "state"]
    assert not caught  # a prune is not corruption


def test_restore_latest_good_falls_back_past_a_torn_file(tmp_path):
    eng = _engine()
    ds = SyntheticPairs(8, 32, 32)
    mgr = CheckpointManager(tmp_path / "ck", keep=5)
    eng.train_epoch(ds.batches(np.arange(4), 4), 0)
    mgr.save(eng)
    eng.train_epoch(ds.batches(np.arange(4), 4), 1)
    mgr.save(eng)
    faults.truncate_file(faults.largest_file(tmp_path / "ck" / "step-0000000002"), keep_bytes=16)
    fresh = _engine()
    with pytest.warns(RuntimeWarning, match="step-0000000002 failed to restore"):
        ck = mgr.restore_latest_good(fresh)
    assert ck.step == 1 and fresh.scheduler.last_epoch == 1


def test_resume_auto_aborts_on_config_mismatch(tmp_path):
    """A checkpoint of another model shape is no corruption: auto-resume
    stops with the report instead of falling back to a fresh start."""
    eng = _engine()
    st = eng.train_state()
    st["model"]["cmg.conv1.weight"] = torch.zeros(99, 12, 3, 3)

    class _Doctored:
        _host_step = 1

        def checkpoint(self, path):
            save_state_atomic(st, path)

    CheckpointManager(tmp_path / "training" / "0" / "checkpoints").save(_Doctored())
    with pytest.raises(CheckpointMismatchError, match=r"cmg\.conv1\.weight"):
        auto_resume(_engine(), tmp_path / "training")


def test_auto_resume_fresh_cases(tmp_path):
    class _NeverRestore:
        def restore(self, path):  # pragma: no cover - must not be called
            raise AssertionError("restore called on a fresh start")

    assert auto_resume(_NeverRestore(), tmp_path / "nope") is None
    (tmp_path / "training" / "0").mkdir(parents=True)
    assert auto_resume(_NeverRestore(), tmp_path / "training") is None


def test_auto_resume_legacy_state_dir(tmp_path):
    eng = _engine()
    eng.train_epoch(SyntheticPairs(8, 32, 32).batches(np.arange(8), 4), 0)
    run = tmp_path / "training" / "0"
    eng.checkpoint(run / "state")
    fresh = _engine()
    assert auto_resume(fresh, tmp_path / "training") == {}  # restored; no position
    assert fresh._host_step == 2 and fresh.scheduler.last_epoch == 2


# ----------------------------------------------------------------------
# Sentinel, preemption guard, epoch control
# ----------------------------------------------------------------------


def test_divergence_budget_exhaustion_raises():
    eng = _engine()
    faults.install(faults.FaultPlan.parse("nan@1,nan@2,nan@3"))
    control = EpochControl(sentinel=DivergenceSentinel(window=1, max_skips=1))
    with pytest.raises(DivergenceError):
        eng.train_epoch(SyntheticPairs(16, 32, 32).batches(np.arange(16), 4, shuffle=False), 0, control=control)


def test_preemption_guard_latches_then_restores():
    prev = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as guard:
        assert not guard.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.requested
    assert signal.getsignal(signal.SIGTERM) is prev


def test_checkpoint_cadence_in_steps():
    calls = []
    control = EpochControl(checkpoint_cb=lambda nb, pm: calls.append(nb), every_steps=2)
    due = [control.checkpoint_due() for _ in range(3)]
    assert due == [False, True, True]
    control.checkpoint(5, [])
    assert calls == [5] and not control.checkpoint_due()


# ----------------------------------------------------------------------
# Heartbeats, perf windows, spans
# ----------------------------------------------------------------------


def test_heartbeat_records_carry_the_jax_writers_keys(tmp_path):
    from waternet_tpu.resilience.heartbeat import HeartbeatWriter as JaxWriter
    from waternet_tpu_torch.resilience import HeartbeatWriter
    from waternet_tpu_torch.resilience.heartbeat import read_heartbeat

    records = []
    for cls, name in ((HeartbeatWriter, "port"), (JaxWriter, "jax")):
        w = cls.resolve(tmp_path / name)
        w.epoch = 3
        assert w.beat(step=7, phase="train", force=True)
        assert not w.beat(step=8)  # throttled inside min_interval_sec
        records.append(read_heartbeat(tmp_path / name / "worker-000.json"))
    got, want = records
    assert got.keys() == want.keys()
    drop = ("time",)
    assert {k: v for k, v in got.items() if k not in drop} == {k: v for k, v in want.items() if k not in drop}
    assert got["process_id"] == 0 and got["phase"] == "train"


def test_heartbeat_dir_from_env(tmp_path, monkeypatch):
    from waternet_tpu_torch.resilience import HeartbeatWriter

    assert HeartbeatWriter.resolve(None) is None
    monkeypatch.setenv("WATERNET_HEARTBEAT_DIR", str(tmp_path))
    assert HeartbeatWriter.resolve(None).path == tmp_path / "worker-000.json"


def test_train_perf_row_equals_jax_on_the_same_clock():
    from waternet_tpu.training.trainer import TrainPerf as JaxPerf
    from waternet_tpu_torch.training.trainer import TrainPerf

    now = [1000.0]
    perfs = [TrainPerf(flops_per_image=3.0e9, peak_tflops=100.0, clock=lambda: now[0]),
             JaxPerf(flops_fn=lambda h, w: 3.0e9, peak_tflops=100.0, clock=lambda: now[0])]
    perfs[1].seed_flops(32, 32)
    for dt in (0.02, 0.03, 0.025, 0.04):
        now[0] += dt
        perfs[0].note_step(dt, 4)
        perfs[1].note_step(dt, 4)
    for p in perfs:
        p.update_gauges()
    got, want = (p.epoch_snapshot() for p in perfs)
    assert got == want and got["mfu_live"] > 0 and got["hbm_peak_bytes"] is None


def test_epoch_driver_records_its_spans():
    eng = _engine()
    trace.reset()
    trace.enable()
    try:
        eng.train_epoch(SyntheticPairs(8, 32, 32).batches(np.arange(8), 4), 0)
        names = [e["name"] for e in trace.recorder().to_chrome()["traceEvents"] if e.get("ph") == "X"]
    finally:
        trace.disable()
        trace.reset()
    assert names.count("step_dispatch") == 2 and names.count("metrics_fetch") == 1


# ----------------------------------------------------------------------
# Data: decode@K in the UIEB loader, iter_batches(start=)
# ----------------------------------------------------------------------


@pytest.mark.parametrize("plan,quarantined", [
    ("decode@1", []),  # one failed attempt, then the retry decodes it
    ("decode@1,decode@2", []),
    ("decode@1,decode@2,decode@3", ["000.png"]),  # all three attempts of 000.png's raw
])
def test_decode_fault_retries_then_quarantines(tmp_path, plan, quarantined):
    """The same plan gives the same verdicts in both packages' loaders."""
    from waternet_tpu.data.uieb import UIEBDataset as JaxUIEB
    from waternet_tpu_torch.data.uieb import UIEBDataset

    write_uieb_tree(tmp_path, 3, 24, 32)
    raw, ref = tmp_path / "raw-890", tmp_path / "reference-890"
    verdicts = []
    for cls, mod in ((UIEBDataset, faults), (JaxUIEB, jax_faults)):
        mod.install(mod.FaultPlan.parse(plan))
        ds = cls(raw, ref, im_height=24, im_width=32)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            clean = ds.prevalidate(np.arange(3))
        verdicts.append((list(clean), ds.quarantined, sorted(mod.active().fired)))
        mod.clear()
    assert verdicts[0] == verdicts[1]
    assert verdicts[0][1] == quarantined and len(verdicts[0][0]) == 3 - len(quarantined)


@pytest.mark.parametrize("start", [0, 1, 3, 4])
def test_iter_batches_start_equals_jax(start):
    from waternet_tpu.data.batching import iter_batches as jax_iter
    from waternet_tpu_torch.data.batching import iter_batches

    ds = SyntheticPairs(14, 8, 8)
    loads = []

    def load(i):
        loads.append(i)
        return ds.load_pair(i)

    kw = dict(batch_size=4, seed=3, epoch=2)
    got = list(iter_batches(load, np.arange(14), start=start, **kw))
    want = list(jax_iter(ds.load_pair, np.arange(14), start=start, **kw))
    assert len(got) == len(want) == max(0, 4 - start)
    assert all(np.array_equal(a, b) for g, w in zip(got, want) for a, b in zip(g, w))
    assert len(loads) == sum(g[0].shape[0] for g in got)  # the skipped ones are not loaded
