"""Resume of the port's training: the full train state
(``TrainingEngine.checkpoint``/``restore``, ``utils/convert.py::
train_state_from_jax``), mid-epoch resume through ``python -m
waternet_tpu_torch.train`` after a preemption, interval checkpoints and the
NaN sentinel, on the CPU, against the port's own uninterrupted runs and
against the JAX package.

The CLI runs in this process, through ``waternet_tpu_torch.train.main``
with the run dirs redirected (as tests/test_resilience.py runs the JAX
CLI): two processes of the CPU torch build can round differently (ROADMAP,
"CPU-build reproducibility note"), so nothing is compared bit for bit
across processes. Within one process the resumed run's
``metrics-train.csv``, ``metrics-val.csv`` and ``last.npz`` equal the
uninterrupted run's byte for byte.

Against the JAX package: after one JAX epoch, ``train_state_from_jax``
gives the port Adam moments equal to JAX's ``mu``/``nu`` exactly (a
relayout), and the next epoch of both packages agrees within rel 1e-3,
the bound of tests/test_torch_hostfed.py, from the trained weights
(``teacher.npz``) for the reason given there.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from waternet_tpu.data.synthetic import SyntheticPairs as JaxPairs
from waternet_tpu.parallel.mesh import make_mesh
from waternet_tpu.resilience import DivergenceSentinel as JaxSentinel
from waternet_tpu.resilience import EpochControl as JaxControl
from waternet_tpu.resilience import faults as jax_faults
from waternet_tpu.training.trainer import TrainConfig as JaxConfig
from waternet_tpu.training.trainer import TrainingEngine as JaxEngine
from waternet_tpu_torch import train as cli
from waternet_tpu_torch.data.synthetic import SyntheticPairs, synthetic_split
from waternet_tpu_torch.resilience import DivergenceSentinel, EpochControl, auto_resume, faults
from waternet_tpu_torch.training.trainer import CheckpointMismatchError, TrainConfig, TrainingEngine
from waternet_tpu_torch.utils import rundir
from waternet_tpu_torch.utils.checkpoint import STATE_FILE, load_weights
from waternet_tpu_torch.utils.convert import state_dict_from_jax, train_state_from_jax

REPO = Path(__file__).resolve().parent.parent
TEACHER = REPO / "tests" / "fixtures" / "distill" / "teacher.npz"
ARGS = ["--device", "cpu", "--synthetic", "8", "--batch-size", "4", "--height", "32", "--width", "32",
        "--no-perceptual", "--precision", "fp32"]
# The ways a step is fed: host-fed synchronous and pipelined, the raw
# device cache (with its precache tables) and the dct8 one; and the cv2
# host preprocessing, whose augment stream a resume moves past the
# trained prefix.
FEEDS = {
    "workers-0": ["--workers", "0"],
    "workers-2": ["--workers", "2"],
    "host-preprocess-workers-0": ["--workers", "0", "--host-preprocess"],
    "host-preprocess-workers-2": ["--workers", "2", "--host-preprocess"],
    "device-cache-raw": ["--device-cache"],
    "device-cache-dct8": ["--device-cache", "--cache-codec", "dct8"],
}


@pytest.fixture(autouse=True)
def _clear_faults():
    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()


def _kw(**over):
    kw = dict(batch_size=4, im_height=32, im_width=32, precision="fp32", perceptual_weight=0.0)
    kw.update(over)
    return kw


def _run_cli(base: Path, name: str, argv: list, monkeypatch) -> Path:
    """``main(ARGS + argv)`` in this process, the run dir ``base/name``;
    ``--resume auto`` scans ``base``'s run dirs, newest first."""
    run = base / name
    monkeypatch.setattr(rundir, "next_run_dir", lambda root, name=None: run)
    monkeypatch.setattr(rundir, "run_dirs_desc", lambda root: sorted(
        (p for p in base.iterdir() if p.is_dir()), key=lambda p: p.stat().st_mtime, reverse=True))
    assert cli.main(ARGS + argv) == 0
    return run


def _assert_same_artifacts(a: Path, b: Path):
    for name in ("metrics-train.csv", "metrics-val.csv"):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    wa, wb = np.load(a / "last.npz"), np.load(b / "last.npz")
    assert sorted(wa.files) == sorted(wb.files)
    assert all(np.array_equal(wa[k], wb[k]) for k in wa.files)


def _flat_state(engine) -> dict:
    """Every tensor of the engine's train state by path, on the CPU."""
    st = engine.train_state()
    out = {f"model/{k}": v for k, v in st["model"].items()}
    for i, s in st["optimizer"]["state"].items():
        out.update({f"optimizer/{i}/{k}": v for k, v in s.items()})
    return {k: v.detach().cpu().clone() for k, v in out.items()}


def _assert_same_state(a, b):
    sa, sb = _flat_state(a), _flat_state(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert a.scheduler.state_dict() == b.scheduler.state_dict()
    assert [g["lr"] for g in a.optimizer.param_groups] == [g["lr"] for g in b.optimizer.param_groups]


# ----------------------------------------------------------------------
# checkpoint -> restore
# ----------------------------------------------------------------------


def test_checkpoint_restore_is_bit_for_bit_across_the_lr_step(tmp_path):
    """Two epochs of 2 steps with lr_step=3: a restore after epoch 1 (step
    2) and epoch 2 in a fresh engine give the uninterrupted run's
    parameters, moments, Adam steps, schedule and lr, which crossed the
    boundary at step 3."""
    ds = SyntheticPairs(8, 32, 32)
    idx = np.arange(7)
    cfg = dict(lr_step=3)
    full = TrainingEngine(TrainConfig(**_kw(**cfg)), device="cpu")
    full.train_epoch(ds.batches(idx, 4, epoch=0), 0)
    full.checkpoint(tmp_path / "state")
    assert (tmp_path / "state" / STATE_FILE).is_file() and not list(tmp_path.glob(".tmp-*"))
    before = _flat_state(full)
    m_full = full.train_epoch(ds.batches(idx, 4, epoch=1), 1)

    resumed = TrainingEngine(TrainConfig(**_kw(**cfg)), device="cpu")
    resumed.restore(tmp_path / "state")
    assert resumed._host_step == 2
    assert all(torch.equal(v, before[k]) for k, v in _flat_state(resumed).items())
    m_resumed = resumed.train_epoch(ds.batches(idx, 4, epoch=1), 1)
    assert m_resumed == m_full
    _assert_same_state(resumed, full)
    assert full.scheduler.last_epoch == 4
    assert full.optimizer.param_groups[0]["lr"] == 1e-3 * 0.1
    assert all(s["step"].item() == 4 for s in full.optimizer.state.values())


def test_checkpoint_is_a_copy_of_the_live_state(tmp_path):
    """The saved state, and a rollback snapshot, do not move with the next
    step; loading a snapshot leaves it valid for another rollback."""
    ds = SyntheticPairs(8, 32, 32)
    eng = TrainingEngine(TrainConfig(**_kw()), device="cpu")
    eng.train_epoch(ds.batches(np.arange(4), 4), 0)
    snap = eng._host_state_copy()
    frozen = {k: v.clone() for k, v in _flat_state(eng).items()}
    eng.checkpoint(tmp_path / "state")
    eng.train_epoch(ds.batches(np.arange(4), 4), 1)
    saved = torch.load(tmp_path / "state" / STATE_FILE, weights_only=True)
    assert torch.equal(saved["model"]["cmg.conv1.weight"], frozen["model/cmg.conv1.weight"])
    eng._own_device_state(snap)
    assert all(torch.equal(v, frozen[k]) for k, v in _flat_state(eng).items())
    eng.train_epoch(ds.batches(np.arange(4), 4), 1)
    assert all(torch.equal(snap["optimizer"]["state"][i]["step"], torch.tensor(1.0)) for i in snap["optimizer"]["state"])


def test_restore_mismatch_names_the_tensor(tmp_path):
    eng = TrainingEngine(TrainConfig(**_kw()), device="cpu")
    st = eng.train_state()
    st["model"]["cmg.conv1.weight"] = torch.zeros(99, 12, 3, 3)
    from waternet_tpu_torch.utils.checkpoint import save_state_atomic

    save_state_atomic(st, tmp_path / "state")
    fresh = TrainingEngine(TrainConfig(**_kw()), device="cpu")
    w = fresh.model.cmg.conv1.weight.detach().clone()
    with pytest.raises(CheckpointMismatchError, match=r"cmg\.conv1\.weight: checkpoint \(99, 12, 3, 3\)"):
        fresh.restore(tmp_path / "state")
    assert torch.equal(fresh.model.cmg.conv1.weight, w)  # untouched


# ----------------------------------------------------------------------
# The state carried from JAX
# ----------------------------------------------------------------------


# The configuration the JAX engine and its port counterparts share: from
# the trained weights, no augmentation, and a schedule step that epoch 2
# crosses.
JAX_OVER = dict(augment=False, lr_step=3)


@pytest.fixture(scope="module")
def jax_engine():
    """The module's one JAX engine (a one-device mesh, ``JAX_OVER``) and a
    host copy of its initial state: its steps donate the device state, so
    each user puts the copy back."""
    eng = JaxEngine(JaxConfig(**_kw(**JAX_OVER)), params=load_weights(TEACHER),
                    mesh=make_mesh(devices=jax.devices()[:1]))
    return eng, eng._host_state_copy()


def _fresh(jax_engine):
    jeng, init = jax_engine
    jeng.state = jeng._own_device_state(init)
    jeng._host_step = 0
    return jeng


def _port_engine() -> TrainingEngine:
    return TrainingEngine(TrainConfig(**_kw(**JAX_OVER)), params=load_weights(TEACHER), device="cpu")


@pytest.fixture(scope="module")
def carried(jax_engine):
    """One JAX epoch, its state carried into the port; then epoch 2 in
    both packages on the same batches (device preprocessing)."""
    n = 16
    train_idx, _ = synthetic_split(n)
    jds, ds = JaxPairs(n, 32, 32), SyntheticPairs(n, 32, 32)
    jeng = _fresh(jax_engine)
    jeng.train_epoch(jds.batches(train_idx, 4, seed=0, epoch=0), epoch=0)
    st = jax.device_get(jeng.state)
    peng = TrainingEngine(TrainConfig(**_kw(**JAX_OVER)), device="cpu")
    peng.load_train_state(train_state_from_jax(st.params, st.opt_state, st.step, peng.config))
    moments = {k: [s[k].clone() for s in peng.optimizer.state_dict()["state"].values()]
               for k in ("exp_avg", "exp_avg_sq", "step")}
    want = jeng.train_epoch(jds.batches(train_idx, 4, seed=0, epoch=1), epoch=1)
    got = peng.train_epoch(ds.batches(train_idx, 4, seed=0, epoch=1), 1)
    return st, peng, moments, got, want


def test_train_state_from_jax_moments_are_jax_mu_nu(carried):
    st, peng, moments, _, _ = carried
    adam = st.opt_state[0]
    names = [n for n, _ in peng.model.named_parameters()]
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        want = state_dict_from_jax(tree)
        for name, got in zip(names, moments[key]):
            assert torch.equal(got, want[name]), (key, name)
    assert all(s.item() == int(adam.count) == 4 for s in moments["step"])


def test_train_state_from_jax_schedule_position(carried):
    """After JAX's 4 steps the schedule and Adam's step equal an
    uninterrupted port run's at step 4, past the lr_step boundary at 3."""
    st = carried[0]
    cfg = TrainConfig(**_kw(lr_step=3))
    eng = TrainingEngine(cfg, device="cpu")
    eng.train_epoch(SyntheticPairs(16, 32, 32).batches(np.arange(16), 4, epoch=0), 0)
    state = train_state_from_jax(st.params, st.opt_state, st.step, cfg)
    assert state["scheduler"] == eng.scheduler.state_dict()
    assert state["optimizer"]["param_groups"] == eng.optimizer.state_dict()["param_groups"]
    assert state["optimizer"]["param_groups"][0]["lr"] == 1e-3 * 0.1
    assert state["step"] == 4


@pytest.mark.parametrize("name", ["mse", "ssim", "psnr", "loss"])
def test_epoch_after_the_carried_state_tracks_jax(carried, name):
    _, _, _, got, want = carried
    assert got[name] == pytest.approx(float(want[name]), rel=1e-3)


# ----------------------------------------------------------------------
# The CLI: preemption, mid-epoch resume, interval checkpoints, NaN guard
# ----------------------------------------------------------------------


@pytest.mark.parametrize("feed", list(FEEDS))
def test_sigterm_midepoch_resume_is_bit_for_bit(tmp_path, monkeypatch, feed):
    """sigterm@3 is a real SIGTERM after global step 3, the first batch of
    epoch 2 (2 steps an epoch): the run checkpoints there and returns; a
    fresh ``--resume auto`` run finishes it with the uninterrupted run's
    CSVs and weights, byte for byte."""
    extra = FEEDS[feed] + ["--epochs", "2"]
    full = _run_cli(tmp_path / "base", "full", extra, monkeypatch)

    work = tmp_path / "work"
    faults.install(faults.FaultPlan.parse("sigterm@3"))
    interrupted = _run_cli(work, "0", extra, monkeypatch)
    faults.clear()
    cks = sorted((interrupted / "checkpoints").glob("step-*"))
    meta = json.loads((cks[-1] / "_COMPLETE.json").read_text())
    assert (meta["epoch"], meta["batch_index"], meta["step"]) == (1, 1, 3)
    assert len(meta["partial_metrics"]) == 1
    assert not (interrupted / "metrics-train.csv").exists()

    resumed = _run_cli(work, "1", extra + ["--resume", "auto"], monkeypatch)
    _assert_same_artifacts(full, resumed)


def test_checkpoint_every_step_writes_a_midepoch_checkpoint(tmp_path, monkeypatch):
    run = _run_cli(tmp_path, "run", ["--epochs", "1", "--checkpoint-every", "1", "--workers", "0"], monkeypatch)
    metas = [json.loads((c / "_COMPLETE.json").read_text()) for c in sorted((run / "checkpoints").glob("step-*"))]
    # Step 1's interval checkpoint, then step 2's, replaced by the epoch end's.
    assert [(m["step"], m["epoch"], m["batch_index"]) for m in metas] == [(1, 0, 1), (2, 1, 0)]
    assert len(metas[0]["partial_metrics"]) == 1


def test_resume_auto_falls_back_past_a_truncated_checkpoint(tmp_path, monkeypatch):
    """truncate_ckpt@2 tears the second managed checkpoint (step 4) after
    it is finalized; ``auto_resume`` warns and restores step 2."""
    faults.install(faults.FaultPlan.parse("truncate_ckpt@2"))
    _run_cli(tmp_path, "0", ["--epochs", "2", "--workers", "0"], monkeypatch)
    faults.clear()
    state = tmp_path / "0" / "checkpoints" / "step-0000000004" / "state" / STATE_FILE
    assert state.stat().st_size < (tmp_path / "0" / "state" / STATE_FILE).stat().st_size
    eng = TrainingEngine(TrainConfig(**_kw()), device="cpu")
    with pytest.warns(RuntimeWarning, match="step-0000000004 failed to restore"):
        meta = auto_resume(eng, tmp_path)
    assert meta["step"] == 2 and (meta["epoch"], meta["batch_index"]) == (1, 0)
    assert eng._host_step == 2 and eng.scheduler.last_epoch == 2


def test_cli_nan_guard_finishes_finite(tmp_path, monkeypatch, capsys):
    faults.install(faults.FaultPlan.parse("nan@3"))
    run = _run_cli(tmp_path, "run", ["--epochs", "2", "--nan-guard", "--workers", "2"], monkeypatch)
    stats = [json.loads(ln.split(" ", 1)[1]) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("epoch_stats ")]
    assert [(s["nan_skipped"], s["nan_rollbacks"]) for s in stats] == [(0.0, 0.0), (1.0, 1.0)]
    assert stats[1]["steps"] == 2
    assert np.isfinite(np.loadtxt(run / "metrics-train.csv", delimiter=",", skiprows=1)).all()
    w = np.load(run / "last.npz")
    assert all(np.isfinite(w[k]).all() for k in w.files)


# nan@K counts dispatches, replays included: under "nan@2,nan@4" the
# replay of batch 0 is dispatch 3, so dispatch 4 is batch 2.
@pytest.mark.parametrize("plan,skipped", [("nan@3", {2}), ("nan@2,nan@4", {1, 2})])
def test_sentinel_counters_equal_jax_for_the_same_plan(jax_engine, plan, skipped):
    """The same fault plan and sentinel window on a 4-step epoch: the port
    skips and rolls back as often as the JAX engine, and its parameters
    and moments end equal to a run that never saw the poisoned batches."""
    ds, jds, idx = SyntheticPairs(16, 32, 32), JaxPairs(16, 32, 32), np.arange(16)
    jeng = _fresh(jax_engine)
    jax_faults.install(jax_faults.FaultPlan.parse(plan))
    want = jeng.train_epoch(jds.batches(idx, 4, shuffle=False), epoch=0,
                            control=JaxControl(sentinel=JaxSentinel(window=2)))
    eng = _port_engine()
    faults.install(faults.FaultPlan.parse(plan))
    got = eng.train_epoch(ds.batches(idx, 4, shuffle=False), 0, control=EpochControl(sentinel=DivergenceSentinel(window=2)))
    faults.clear()
    assert (got["nan_skipped"], got["nan_rollbacks"]) == (want["nan_skipped"], want["nan_rollbacks"])
    assert all(math.isfinite(v) for v in got.values())

    ref = _port_engine()
    batches = list(ds.batches(idx, 4, shuffle=False))
    for i, b in enumerate(batches):
        if i not in skipped:
            ref.train_epoch(iter([b]), 0, start_batch=i)
    _assert_same_state_params(eng, ref)


def _assert_same_state_params(a, b):
    sa, sb = _flat_state(a), _flat_state(b)
    for k in sa:
        if not k.endswith("/step"):
            assert torch.equal(sa[k], sb[k]), k


def test_preempted_pipeline_joins_its_workers(tmp_path):
    """A preemption with batches in flight closes the pipeline: the
    conftest leak guard sees no thread left, and the position is exact."""
    from waternet_tpu_torch.resilience import Preempted, PreemptionGuard

    ds = SyntheticPairs(32, 32, 32)
    eng = TrainingEngine(TrainConfig(**_kw()), device="cpu")
    faults.install(faults.FaultPlan.parse("sigterm@2"))
    with PreemptionGuard() as guard:
        with pytest.raises(Preempted) as exc:
            eng.train_epoch_pipelined(ds, np.arange(32), 0, workers=2, prefetch=4,
                                      control=EpochControl(preemption=guard))
    assert exc.value.next_batch == 2 and len(exc.value.partial) == 2
    assert eng._host_step == 2


def test_debug_nans_names_the_op(tmp_path, monkeypatch):
    """--debug-nans runs a clean epoch to its end, and stops at the first
    operation that makes a NaN (here the nan fault's in-place poison)."""
    _run_cli(tmp_path, "clean", ["--epochs", "1", "--workers", "0", "--debug-nans"], monkeypatch)
    faults.install(faults.FaultPlan.parse("nan@1"))
    with pytest.raises(FloatingPointError, match=r"invalid value \(nan\) encountered in aten\.mul_"):
        _run_cli(tmp_path, "nan", ["--epochs", "1", "--workers", "0", "--debug-nans"], monkeypatch)
    from waternet_tpu_torch.utils.debug_nans import NanCheckMode

    with NanCheckMode(), pytest.raises(FloatingPointError, match=r"aten\.sqrt"):
        torch.sqrt(torch.tensor([-1.0]))


def test_perf_csv_and_profile_dir(tmp_path, monkeypatch):
    run = _run_cli(tmp_path, "run", ["--epochs", "2", "--workers", "0", "--perf-csv",
                                     "--profile-dir", str(tmp_path / "prof")], monkeypatch)
    lines = (run / "metrics-train.csv").read_text().splitlines()
    assert lines[0] == "mse,ssim,psnr,perceptual_loss,loss,mfu_live,hbm_peak_bytes"
    assert all(ln.endswith(",nan,nan") for ln in lines[1:])  # unmeasurable on the CPU
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert any("conv" in str(e.get("name", "")) for e in trace["traceEvents"])
