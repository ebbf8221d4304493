"""The port's host-fed training (``TrainingEngine.train_epoch``,
``train_epoch_pipelined``, the eval epochs, ``python -m
waternet_tpu_torch.train`` without ``--device-cache``) against the JAX
package, on the CPU.

The JAX engine runs on a one-device mesh: the port runs on one device and
pads no batch, and on the suite's 8 forced CPU devices the JAX engine
would pad every batch to 8 rows and draw augmentations for those rows too.

Tolerances: the host stage (augment + cv2 WB/GC/CLAHE + the ``/255``
views) is bit-exact; epoch metrics against JAX within rel 1e-3, the
tolerance of tests/test_torch_trainer.py::test_cached_epochs_track_jax
and for its reason: the first Adam step moves each weight by about
lr * sign(g), so float noise in tiny gradients moves a few weights by up
to 2 * lr. The JAX comparison starts from the committed trained weights
(``teacher.npz``). From the JAX package's random init those sign flips
make the device-preprocess epochs on raw pairs drift apart by more than
rel 1e-3 by the second epoch (ROADMAP Queue C): a property of Adam on
near-zero gradients, whose first step the gradient test of
tests/test_torch_trainer.py holds, not of the feed, which the
bit-for-bit tests below hold. Within the port, pipelined and synchronous
epochs, and host-fed and cached-raw device-preprocess epochs, are equal
bit for bit.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from waternet_tpu.data.synthetic import SyntheticPairs as JaxPairs
from waternet_tpu.parallel.mesh import make_mesh
from waternet_tpu.training.trainer import TrainConfig as JaxConfig
from waternet_tpu.training.trainer import TrainingEngine as JaxEngine
from waternet_tpu_torch.data.synthetic import SyntheticPairs, synthetic_split
from waternet_tpu_torch.training import trainer
from waternet_tpu_torch.training.trainer import TrainConfig, TrainingEngine
from waternet_tpu_torch.utils.checkpoint import load_weights
from tests.test_torch_uieb import write_uieb_tree

REPO = Path(__file__).resolve().parent.parent
TEACHER = REPO / "tests" / "fixtures" / "distill" / "teacher.npz"
N, HW, BATCH = 16, 32, 4  # 14 train pairs (batches of 4, 4, 4, 2), 2 val
PIPELINE_KEYS = {
    "pipeline_stall_pct", "pipeline_stall_pct_window", "pipeline_queue_depth",
    "pipeline_workers", "pipeline_transfer_bytes_per_batch", "pipeline_load_ms",
    "pipeline_preprocess_ms", "pipeline_transfer_ms", "pipeline_step_ms",
}


def _kw(**over):
    kw = dict(batch_size=BATCH, im_height=HW, im_width=HW, precision="fp32", perceptual_weight=0.0)
    kw.update(over)
    return kw


def _jax_engine(params=None, **over):
    return JaxEngine(JaxConfig(**_kw(**over)), params=params, mesh=make_mesh(devices=jax.devices()[:1]))


@pytest.mark.parametrize("hw", [(32, 32), (24, 40)], ids=["square", "non-square"])
def test_host_preprocess_np_equals_jax_bit_for_bit(hw):
    """The same batch and the same numpy RNG state give the same five
    views, with augmentation on (and the same stream position after)."""
    h, w = hw
    ds = SyntheticPairs(6, h, w, seed=2)
    raw, ref = (np.stack(a) for a in zip(*(ds.load_pair(i) for i in range(6))))
    jeng = _jax_engine(im_height=h, im_width=w)
    peng = TrainingEngine(TrainConfig(**_kw(im_height=h, im_width=w)), device="cpu")
    rng_j, rng_p = np.random.default_rng(11), np.random.default_rng(11)
    want = jeng._host_preprocess_np(raw, ref, rng_j)
    got = peng._host_preprocess_np(raw, ref, rng_p)
    assert len(got) == 5
    for g, w_ in zip(got, want):
        assert g.dtype == np.float32 and np.array_equal(g, w_)
    assert rng_j.bit_generator.state == rng_p.bit_generator.state
    # Without a generator (eval), nothing is augmented.
    for g, w_ in zip(peng._host_preprocess_np(raw, ref), jeng._host_preprocess_np(raw, ref)):
        assert np.array_equal(g, w_)


@pytest.fixture(scope="module")
def jax_runs():
    """Two epochs of the JAX engine (synchronous, one-device mesh) and of the
    port (pipelined, 2 workers) from the trained weights, in each
    preprocess mode: host with augmentation, device without."""
    train_idx, val_idx = synthetic_split(N)
    jds, ds = JaxPairs(N, HW, HW), SyntheticPairs(N, HW, HW)
    teacher = load_weights(TEACHER)
    runs = {}
    for mode, over in (("host", dict(host_preprocess=True, augment=True)),
                       ("device", dict(augment=False))):
        jeng = _jax_engine(params=teacher, **over)
        peng = TrainingEngine(TrainConfig(**_kw(**over)), params=teacher, device="cpu")
        got, want = [], []
        for epoch in range(2):
            want.append((
                jeng.train_epoch(jds.batches(train_idx, BATCH, seed=0, epoch=epoch), epoch=epoch),
                jeng.eval_epoch(jds.batches(val_idx, BATCH, shuffle=False)),
            ))
            got.append((
                peng.train_epoch_pipelined(ds, train_idx, epoch, workers=2),
                peng.eval_epoch_pipelined(ds, val_idx, workers=2),
            ))
        runs[mode] = (got, want)
    return runs


@pytest.mark.parametrize("mode", ["host", "device"])
@pytest.mark.parametrize("epoch", [0, 1])
@pytest.mark.parametrize("split", ["train", "val"])
def test_host_fed_epochs_track_jax(jax_runs, mode, epoch, split):
    got, want = jax_runs[mode]
    part = 0 if split == "train" else 1
    g, w = got[epoch][part], want[epoch][part]
    names = trainer.TRAIN_METRICS_NAMES if split == "train" else trainer.VAL_METRICS_NAMES
    assert set(g) == set(names) | PIPELINE_KEYS
    for k in names:
        np.testing.assert_allclose(g[k], w[k], rtol=1e-3, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("mode", ["host", "device"])
def test_pipeline_transfer_bytes_per_batch(jax_runs, mode):
    """Two uint8 tensors per batch on the device-preprocess path, five
    float32 views on the host-preprocess path: ten times the bytes. The
    train epoch's batches are 4, 4, 4 and 2 pairs."""
    got, _ = jax_runs[mode]
    per_item = 2 * HW * HW * 3 if mode == "device" else 5 * HW * HW * 3 * 4
    train, val = got[1]
    assert train["pipeline_transfer_bytes_per_batch"] == per_item * 14 / 4
    assert val["pipeline_transfer_bytes_per_batch"] == per_item * 2
    assert train["pipeline_workers"] == 2.0
    assert (train["pipeline_preprocess_ms"] > 0) == (mode == "host")


def _state(engine):
    return {k: v.clone() for k, v in engine.model.state_dict().items()}


def _equal(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(
        torch.equal(a[k], b[k]) if torch.is_tensor(a[k]) else a[k] == b[k] for k in a
    )


@pytest.mark.parametrize("host_preprocess", [True, False], ids=["host", "device"])
def test_pipelined_epochs_equal_synchronous(host_preprocess):
    """Workers 2 and 0 and the synchronous ``train_epoch`` over
    ``dataset.batches``: the same metrics and parameters, bit for bit."""
    ds = SyntheticPairs(N, HW, HW)
    train_idx, val_idx = synthetic_split(N)
    cfg = _kw(host_preprocess=host_preprocess, augment=True)
    out = {}
    for how in ("sync", "workers0", "workers2"):
        eng = TrainingEngine(TrainConfig(**cfg), device="cpu")
        ms = []
        for epoch in range(2):
            if how == "sync":
                ms.append(eng.train_epoch(ds.batches(train_idx, BATCH, seed=0, epoch=epoch), epoch))
                ms.append(eng.eval_epoch(ds.batches(val_idx, BATCH, shuffle=False)))
            else:
                w = int(how[-1])
                ms.append(eng.train_epoch_pipelined(ds, train_idx, epoch, workers=w))
                ms.append(eng.eval_epoch_pipelined(ds, val_idx, workers=w))
        metrics = [{k: v for k, v in m.items() if not k.startswith("pipeline_")} for m in ms]
        out[how] = (metrics, _state(eng))
    for how in ("workers0", "workers2"):
        assert out[how][0] == out["sync"][0], how
        assert _equal(out[how][1], out["sync"][1]), how


def test_device_preprocess_host_fed_equals_cached_raw():
    """A batch gives the same step whether it came from the host or from
    the raw device cache: the same Philox batches and the same per-step
    augmentation generator, so two epochs agree bit for bit."""
    ds = SyntheticPairs(N, HW, HW)
    train_idx, val_idx = synthetic_split(N)
    cfg = _kw(augment=True, cache_codec="raw", precache_histeq=False)
    cached = TrainingEngine(TrainConfig(**cfg), device="cpu")
    cached.cache_dataset(ds, train_idx)
    fed = TrainingEngine(TrainConfig(**cfg), device="cpu")
    for epoch in range(2):
        want = (cached.train_epoch_cached(epoch), cached.eval_epoch_cached(ds, val_idx))
        got = (fed.train_epoch_pipelined(ds, train_idx, epoch, workers=2),
               fed.eval_epoch_pipelined(ds, val_idx, workers=2))
        for g, w in zip(got, want):
            assert {k: g[k] for k in w} == w
    assert _equal(_state(fed), _state(cached))


def test_host_preprocess_engine_and_device_cache_refusal():
    engine = TrainingEngine(TrainConfig(**_kw(host_preprocess=True)), device="cpu")
    with pytest.raises(ValueError, match="device preprocessing"):
        engine.cache_dataset(SyntheticPairs(4, HW, HW), np.arange(4))


def _cli(args):
    return subprocess.run(
        [sys.executable, "-m", "waternet_tpu_torch.train", "--device", "cpu", *args],
        cwd=REPO, capture_output=True, text=True, timeout=600,
    )


def _epoch_stats(stdout):
    return [json.loads(ln.split(" ", 1)[1]) for ln in stdout.splitlines() if ln.startswith("epoch_stats ")]


SMALL = ["--epochs", "2", "--batch-size", "4", "--height", "32", "--width", "32",
         "--no-perceptual", "--precision", "fp32"]


@pytest.mark.parametrize("workers", ["2", "0"])
def test_train_cli_host_fed(tmp_path, workers):
    """Host-fed from ``--synthetic``, pipelined and synchronous. Their
    equality is held in one process (test_pipelined_epochs_equal_synchronous):
    two processes of the CPU build occasionally round differently, with
    either worker count (ROADMAP Queue C)."""
    proc = _cli(["--synthetic", "16", *SMALL, "--workers", workers, "--train-root", str(tmp_path)])
    assert proc.returncode == 0, proc.stderr
    stats = _epoch_stats(proc.stdout)
    assert len(stats) == 2 and stats[0]["steps"] == 4
    for s in stats:
        assert all(np.isfinite(v) for v in list(s["train"].values()) + list(s["val"].values()))
    run = tmp_path / "0"
    for name in ("last.npz", "metrics-train.csv", "metrics-val.csv", "summary.json", "config.json"):
        assert (run / name).is_file(), name
    config = json.loads((run / "config.json").read_text())
    assert config["device_preprocess"] is True and config["cache_codec"] is None
    if workers == "2":
        assert stats[1]["pipeline_workers"] == 2.0
        assert stats[1]["pipeline_transfer_bytes_per_batch"] == 2 * 32 * 32 * 3 * 14 / 4
        assert stats[1]["val_pipeline"]["pipeline_workers"] == 2.0
    else:
        assert not any(k.startswith("pipeline_") for k in stats[1]) and stats[1]["val_pipeline"] == {}


def test_train_cli_host_preprocess_epoch(tmp_path):
    proc = _cli(["--synthetic", "16", *SMALL, "--epochs", "1", "--host-preprocess",
                 "--train-root", str(tmp_path)])
    assert proc.returncode == 0, proc.stderr
    (stats,) = _epoch_stats(proc.stdout)
    assert stats["pipeline_transfer_bytes_per_batch"] == 5 * 32 * 32 * 3 * 4 * 14 / 4
    assert stats["pipeline_preprocess_ms"] > 0
    assert all(np.isfinite(v) for v in stats["train"].values())
    assert json.loads((tmp_path / "0" / "config.json").read_text())["device_preprocess"] is False


def test_train_cli_from_data_root(tmp_path):
    """UIEB from ``--data-root``: the reference split of the pairs, each
    resized to 32x32 on load."""
    root = write_uieb_tree(tmp_path / "uieb", n=10)
    proc = _cli(["--data-root", str(root), "--val-size", "2", *SMALL, "--epochs", "1",
                 "--train-root", str(tmp_path / "runs")])
    assert proc.returncode == 0, proc.stderr
    (stats,) = _epoch_stats(proc.stdout)
    assert stats["train_images"] == 8 and stats["steps"] == 2
    assert all(np.isfinite(v) for v in list(stats["train"].values()) + list(stats["val"].values()))
    assert (tmp_path / "runs" / "0" / "last.npz").is_file()
