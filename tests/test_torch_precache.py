"""The port's precache tables (``TrainConfig.precache_histeq`` with the raw
device cache, and ``precache_vgg_ref``) against the in-step path and the
JAX package, on the CPU, at 32x32, batch 4, 8 pairs, fp32.

Tolerances, each with its reason:
* the dihedral helpers: bit for bit against ``apply_augment_batch`` (pure
  data movement);
* the tables against JAX's ops run op by op over JAX's ``dihedral_apply``:
  WB and GC bit for bit; the CLAHE table bit for bit where op-by-op JAX is
  cv2-exact, else at most one level on at most 0.5% of the pixels (the
  float LAB inverse, ROADMAP Queue C);
* precached epochs against the port's in-step raw-cache epochs: equal
  exactly, with augmentation and shuffle on (WB and gamma commute with
  every flip and rot90; CLAHE is read from the variant the draws pick);
* precached epochs against the JAX engine's (augment off, from the
  trained weights, one-device mesh): rel 1e-3, the bound and reason of
  tests/test_torch_trainer.py::test_cached_epochs_track_jax;
* ``precache_vgg_ref`` against in-step: rel 1e-4, abs 1e-6, the JAX
  package's bound (tests/test_training.py): the table's VGG forward runs
  on another batch composition, so its features may round differently.

Torch runs on two threads in these tests and in the CLIs they start: the
suite runs files side by side, and eight spinning threads a process would
oversubscribe the cores.
"""

import itertools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from waternet_tpu.data.augment import dihedral_apply as jax_dihedral_apply
from waternet_tpu.data.synthetic import SyntheticPairs as JaxPairs
from waternet_tpu.ops import gamma_correction as jax_gamma
from waternet_tpu.ops import histeq as jax_histeq
from waternet_tpu.ops import white_balance as jax_wb
from waternet_tpu.parallel.mesh import make_mesh
from waternet_tpu.training.trainer import TrainConfig as JaxConfig
from waternet_tpu.training.trainer import TrainingEngine as JaxEngine
from waternet_tpu_torch.data import augment, codec
from waternet_tpu_torch.data.augment import apply_augment_batch, dihedral_apply, dihedral_variant_index
from waternet_tpu_torch.data.synthetic import SyntheticPairs, synthetic_split
from waternet_tpu_torch.training import trainer
from waternet_tpu_torch.training.trainer import TrainConfig, TrainingEngine
from waternet_tpu_torch.utils.checkpoint import load_weights

REPO = Path(__file__).resolve().parent.parent
TEACHER = REPO / "tests" / "fixtures" / "distill" / "teacher.npz"
N, HW, BATCH = 8, 32, 4  # 7 train pairs (batches of 4 and 3), 1 val
DRAWS = list(itertools.product((False, True), (False, True), range(4)))


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _kw(**over):
    kw = dict(batch_size=BATCH, im_height=HW, im_width=HW, precision="fp32", perceptual_weight=0.0)
    kw.update(over)
    return kw


def _state(engine):
    return {k: v.clone() for k, v in engine.model.state_dict().items()}


@pytest.mark.parametrize("draw", DRAWS, ids=lambda d: "h%dv%dk%d" % d)
@pytest.mark.parametrize("hw", [(6, 6), (4, 6)], ids=["square", "non-square"])
def test_dihedral_apply_equals_apply_augment_batch(hw, draw):
    """Every draw is its canonical variant, bit for bit, on tensors and on
    numpy arrays."""
    h, w = hw
    x = torch.arange(3 * h * w * 3, dtype=torch.float32).reshape(3, h, w, 3)
    hflip, vflip, rotk = (torch.tensor([v] * 3) for v in draw)
    want = apply_augment_batch(x, hflip, vflip, rotk.to(torch.int32))
    variant = dihedral_variant_index(hflip, vflip, rotk, h == w)
    assert variant.dtype == torch.int64 and len(set(variant.tolist())) == 1
    v = int(variant[0])
    assert 0 <= v < augment.dihedral_variant_count(h, w)
    assert torch.equal(dihedral_apply(x, v, h == w), want)
    v_np = dihedral_variant_index(*(t.numpy() for t in (hflip, vflip, rotk)), h == w)
    assert v_np.tolist() == variant.tolist()
    assert np.array_equal(dihedral_apply(x.numpy(), v, h == w), want.numpy())


def test_variant_count_has_one_home():
    assert augment.dihedral_variant_count is codec.dihedral_variant_count
    for h, w, n in ((6, 6, 8), (4, 6, 4)):
        reached = {int(dihedral_variant_index(*(torch.tensor([d]) for d in draw), h == w)[0]) for draw in DRAWS}
        assert reached == set(range(n))


@pytest.fixture(scope="module")
def tables():
    """The port's tables (transform_tables on the CPU) and the JAX ops'
    over JAX's dihedral variants, op by op, from the same numpy pairs."""
    ds = SyntheticPairs(N, HW, HW)
    raw = np.stack([ds.load_pair(i)[0] for i in range(N)])
    got = [t.numpy() for t in trainer.transform_tables(torch.from_numpy(raw), 8, BATCH)]
    f = jnp.asarray(raw.astype(np.float32))
    with jax.disable_jit():
        wb = np.asarray(jax.vmap(jax_wb)(f)).astype(np.uint8)
        gc = np.asarray(jax.vmap(jax_gamma)(f)).astype(np.uint8)
        stacked = jnp.concatenate([jax_dihedral_apply(f, v, True) for v in range(8)])
        he = np.asarray(jax.vmap(jax_histeq)(stacked)).astype(np.uint8).reshape(8, N, HW, HW, 3)
    return dict(zip(("wb", "gc", "he"), got)), {"wb": wb, "gc": gc, "he": he}


@pytest.mark.parametrize("name", ["wb", "gc", "he"])
def test_tables_match_jax(tables, name):
    got, want = tables[0][name], tables[1][name]
    assert got.shape == want.shape and got.dtype == np.uint8
    if name != "he":
        np.testing.assert_array_equal(got, want)
        return
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() <= 0.005, (diff > 0).mean()


@pytest.mark.parametrize("hw,perceptual", [((32, 32), 0.05), ((32, 24), 0.0)], ids=["square", "non-square"])
def test_precached_epochs_equal_in_step(hw, perceptual):
    """Two epochs, augment and shuffle on (perceptual on for the square
    size): the precached step and the in-step raw-cache step give the
    same metrics and parameters, train and eval (val cache and train
    cache), exactly."""
    h, w = hw
    ds = SyntheticPairs(N, h, w)
    train_idx, val_idx = synthetic_split(N)
    runs = []
    for pre in (True, False):
        cfg = TrainConfig(**_kw(im_height=h, im_width=w, perceptual_weight=perceptual, augment=True,
                                shuffle=True, precache_histeq=pre))
        eng = TrainingEngine(cfg, device="cpu")
        eng.cache_dataset(ds, train_idx)
        step_fn, _ = eng.cached_train_step()
        assert step_fn == (eng.train_step_cached_pre if pre else eng.train_step_cached_codec)
        assert (eng._cache_pre is not None) == pre
        metrics = [(eng.train_epoch_cached(e), eng.eval_epoch_cached(ds, val_idx), eng.eval_epoch_cached())
                   for e in range(2)]
        runs.append((metrics, _state(eng)))
    (m_pre, sd_pre), (m_in, sd_in) = runs
    assert m_pre == m_in
    assert all(torch.equal(sd_pre[k], sd_in[k]) for k in sd_in)


def test_cached_pre_step_stamps_every_stage():
    ds = SyntheticPairs(BATCH, HW, HW)
    eng = TrainingEngine(TrainConfig(**_kw()), device="cpu")
    eng.cache_dataset(ds, np.arange(BATCH))
    names = []
    step_fn, args = eng.cached_train_step()
    step_fn(*args, torch.arange(BATCH), trainer.step_generator(0, 0, 0), BATCH, stamp=names.append)
    assert names == ["gather_decode", "preprocess", "forward", "losses", "backward", "optimizer", "metrics"]


@pytest.fixture(scope="module")
def jax_runs():
    """Two precached epochs of the JAX engine (one-device mesh) and of the
    port, augment off, from the trained weights."""
    train_idx, val_idx = synthetic_split(N)
    jds, ds = JaxPairs(N, HW, HW), SyntheticPairs(N, HW, HW)
    teacher = load_weights(TEACHER)
    kw = _kw(augment=False)
    jeng = JaxEngine(JaxConfig(**kw), params=teacher, mesh=make_mesh(devices=jax.devices()[:1]))
    peng = TrainingEngine(TrainConfig(**kw), params=teacher, device="cpu")
    jeng.cache_dataset(jds, train_idx)
    peng.cache_dataset(ds, train_idx)
    assert jeng._cache_he is not None and peng._cache_pre is not None
    runs = {"jax": [], "port": []}
    for epoch in range(2):
        runs["jax"].append((jeng.train_epoch_cached(epoch), jeng.eval_epoch_cached(jds, val_idx)))
        runs["port"].append((peng.train_epoch_cached(epoch), peng.eval_epoch_cached(ds, val_idx)))
    return runs


@pytest.mark.parametrize("epoch", [0, 1])
@pytest.mark.parametrize("split", ["train", "val"])
def test_precached_epochs_track_jax(jax_runs, epoch, split):
    part = 0 if split == "train" else 1
    want, got = jax_runs["jax"][epoch][part], jax_runs["port"][epoch][part]
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-6, err_msg=k)


def test_precache_vgg_ref_matches_in_step():
    ds = SyntheticPairs(N, HW, HW)
    train_idx, val_idx = synthetic_split(N)
    runs = {}
    for vgg_ref in (False, True):
        eng = TrainingEngine(TrainConfig(**_kw(perceptual_weight=0.05, precache_vgg_ref=vgg_ref)), device="cpu")
        eng.cache_dataset(ds, train_idx)
        assert (eng._cache_pre["vgg_ref"] is not None) == vgg_ref
        runs[vgg_ref] = [(eng.train_epoch_cached(0), eng.eval_epoch_cached(ds, val_idx))]
    for (tr_got, va_got), (tr_want, va_want) in zip(runs[True], runs[False]):
        for got, want in ((tr_got, tr_want), (va_got, va_want)):
            assert list(got) == list(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize(
    "over,match",
    [
        (dict(cache_codec="dct8"), "requires cache_codec='raw'"),
        (dict(cache_codec="auto"), "requires cache_codec='raw'"),
        (dict(precache_histeq=False), "requires precache_histeq=True"),
        (dict(perceptual_weight=0.0), "nonzero perceptual_weight"),
    ],
    ids=["dct8", "auto", "no-histeq", "no-perceptual"],
)
def test_precache_vgg_ref_rules(over, match):
    kw = _kw(perceptual_weight=0.05, precache_vgg_ref=True)
    kw.update(over)
    eng = TrainingEngine(TrainConfig(**kw), device="cpu")
    with pytest.raises(ValueError, match=match):
        eng.cache_dataset(SyntheticPairs(4, HW, HW), np.arange(4))
    assert eng.cache_resident_bytes() is None


def test_precache_vgg_ref_with_distill_stays_refused():
    """The JAX trainer's rule and error: the feature table holds vgg(ref),
    and the distillation target is the teacher's output."""
    eng = TrainingEngine(TrainConfig(**_kw(distill=True, precache_vgg_ref=True)), device="cpu",
                         teacher_params=load_weights(TEACHER))
    with pytest.raises(ValueError, match="precache_vgg_ref is incompatible with distill"):
        eng.cache_dataset(SyntheticPairs(4, 16, 16, seed=0), np.arange(4))


@pytest.mark.parametrize("codec_name", ["yuv420", "dct8"])
def test_lossy_codecs_build_no_table(codec_name):
    eng = TrainingEngine(TrainConfig(**_kw(cache_codec=codec_name)), device="cpu")
    eng.cache_dataset(SyntheticPairs(4, HW, HW), np.arange(4))
    assert eng._cache_pre is None
    assert eng.cached_train_step()[0] == eng.train_step_cached_codec
    assert eng.cache_resident_bytes() == codec.estimate_cache_bytes(codec_name, 4, HW, HW, precache_histeq=True)


@pytest.mark.parametrize(
    "h,w,vgg_ref", [(32, 32, False), (32, 32, True), (32, 24, True)],
    ids=["square", "square-vggref", "non-square-vggref"],
)
def test_cache_resident_bytes_match_the_estimate(h, w, vgg_ref):
    eng = TrainingEngine(TrainConfig(**_kw(im_height=h, im_width=w, perceptual_weight=0.05,
                                           precache_vgg_ref=vgg_ref)), device="cpu")
    eng.cache_dataset(SyntheticPairs(5, h, w), np.arange(5))
    n_var = codec.dihedral_variant_count(h, w)
    pre = eng._cache_pre
    assert pre["he"].shape == (n_var, 5, h, w, 3) and pre["wb"].shape == (5, h, w, 3)
    feat = (h // 16) * (w // 16) * 512 * 4
    if vgg_ref:
        assert pre["vgg_ref"].shape == (n_var, 5, h // 16, w // 16, 512)
        assert pre["vgg_ref"].dtype == torch.float32
    assert eng.cache_resident_bytes() == codec.estimate_cache_bytes(
        "raw", 5, h, w, precache_histeq=True, precache_vgg_ref=vgg_ref, vgg_ref_bytes_per_item=feat
    )


def _cli(args):
    return subprocess.run(
        [sys.executable, "-m", "waternet_tpu_torch.train", "--device", "cpu", *args],
        cwd=REPO, capture_output=True, text=True, timeout=600, env={**os.environ, "OMP_NUM_THREADS": "2"},
    )


SMALL = ["--synthetic", "16", "--epochs", "1", "--batch-size", "4", "--height", "32", "--width", "32",
         "--precision", "fp32"]


@pytest.mark.parametrize("extra", [["--no-perceptual"], ["--precache-vgg-ref"]],
                         ids=["device-cache", "precache-vgg-ref"])
def test_train_cli_device_cache_precaches(tmp_path, extra):
    """``--device-cache`` alone now builds the tables (no
    ``--no-precache-histeq`` needed); ``--precache-vgg-ref`` adds VGG's."""
    vgg_ref = extra == ["--precache-vgg-ref"]
    proc = _cli([*SMALL, "--device-cache", *extra, "--train-root", str(tmp_path)])
    assert proc.returncode == 0, proc.stderr
    (build,) = [json.loads(ln.split(" ", 1)[1]) for ln in proc.stdout.splitlines() if ln.startswith("cache_build ")]
    assert build["precache_histeq"] is True and build["precache_vgg_ref"] == vgg_ref
    vgg = 8 * 14 * 2 * 2 * 512 * 4 if vgg_ref else 0
    assert build["hbm_cache_bytes"] == 14 * (2 + 2 + 8) * 32 * 32 * 3 + vgg
    stats = [json.loads(ln.split(" ", 1)[1]) for ln in proc.stdout.splitlines() if ln.startswith("epoch_stats ")]
    assert len(stats) == 1
    for s in stats:
        assert all(np.isfinite(v) for v in list(s["train"].values()) + list(s["val"].values()))
    config = json.loads((tmp_path / "0" / "config.json").read_text())
    assert config["cache_codec"] == "raw" and config["cache_resident_bytes"] == build["hbm_cache_bytes"]
    assert config["precache_histeq"] is True and config["precache_vgg_ref"] == vgg_ref


@pytest.mark.parametrize(
    "args,match",
    [
        (["--precache-vgg-ref"], "requires --device-cache"),
        (["--device-cache", "--precache-vgg-ref", "--no-perceptual"], "nonzero perceptual_weight"),
        (["--device-cache", "--precache-vgg-ref", "--cache-codec", "dct8"], "requires cache_codec='raw'"),
        (["--device-cache", "--precache-vgg-ref", "--no-precache-histeq"], "requires precache_histeq=True"),
    ],
    ids=["no-device-cache", "no-perceptual", "dct8", "no-histeq"],
)
def test_train_cli_refuses_what_jax_refuses(tmp_path, args, match):
    proc = _cli([*SMALL, *args, "--train-root", str(tmp_path)])
    assert proc.returncode != 0 and match in proc.stderr, proc.stderr
    assert not (tmp_path / "0").exists()
