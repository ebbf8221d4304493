"""The port's training slice (waternet_tpu_torch.training, ``python -m
waternet_tpu_torch.train``) against the JAX package, on the CPU.

Tolerances, each with its reason:
* one fp32 step, perceptual on: loss, MSE and perceptual term within rel
  1e-5; WaterNet's gradients per tensor within 1e-4 * max|g| of that
  tensor. Both sides are float32 convolutions, summed in other orders;
* epochs (dct8 cache, 2 epochs, perceptual off): the epoch metrics within
  rel 1e-3. The first Adam step moves every weight by about lr * sign(g),
  so float noise in tiny gradients moves a few weights by up to 2 * lr and
  the two runs drift apart slowly from there; the decoded batches may
  also differ by one uint8 level at rare rounding ties;
* bf16: the step's loss within rel 2e-2 of JAX's bf16 step. Both compute
  in bfloat16 (8 bits of mantissa) but round at other places;
* the CLI's ``last.npz`` loaded by the JAX package: its forward within
  ``atol=2e-5`` of the port's, the fp32 bound of tests/test_convert.py.
"""

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

from waternet_tpu.data.synthetic import SyntheticPairs as JaxPairs
from waternet_tpu.models.vgg import VGG19Features as JaxVGG
from waternet_tpu.models.vgg import init_vgg_params as jax_init_vgg
from waternet_tpu.models.waternet import WaterNet as JaxWaterNet
from waternet_tpu.training import losses as jlosses
from waternet_tpu.training.trainer import TrainConfig as JaxConfig
from waternet_tpu.training.trainer import TrainingEngine as JaxEngine
from waternet_tpu_torch.data import codec
from waternet_tpu_torch.data.synthetic import SyntheticPairs, synthetic_split
from waternet_tpu_torch.ops.fused import fused_train_preprocess
from waternet_tpu_torch.training import trainer
from waternet_tpu_torch.training.trainer import TrainConfig, TrainingEngine
from waternet_tpu_torch.utils.checkpoint import load_weights
from waternet_tpu_torch.utils.convert import state_dict_from_jax

REPO = Path(__file__).resolve().parent.parent
TEACHER = REPO / "tests" / "fixtures" / "distill" / "teacher.npz"


@pytest.fixture(scope="module")
def jax_vgg_params():
    return jax.tree.map(np.asarray, jax_init_vgg())


@pytest.fixture(scope="module")
def teacher():
    return load_weights(TEACHER)


def _views(n=2, hw=32, seed=0):
    """The five [0, 1] training views of a synthetic batch, as numpy."""
    ds = SyntheticPairs(n, hw, hw, seed=seed)
    raw, ref = (torch.from_numpy(np.stack(a)) for a in zip(*(ds.load_pair(i) for i in range(n))))
    with torch.no_grad():
        return [t.numpy() for t in fused_train_preprocess(raw, ref, None, augment=False)]


def _jax_loss_fn(precision, vgg_params, views, perceptual=True):
    dtype = jnp.bfloat16 if precision == "bf16" else jnp.float32
    model, vgg = JaxWaterNet(dtype=dtype), JaxVGG(dtype=dtype)
    x, wbn, hen, gcn, refn = (jnp.asarray(v) for v in views)

    def loss_fn(params):
        out = model.apply(params, x, wbn, hen, gcn)
        mse = jlosses.mse_255(out, refn)
        perc = jlosses.perceptual_loss(vgg, vgg_params, out, refn) if perceptual else 0.0
        return jlosses.PERCEPTUAL_WEIGHT * perc + mse, (mse, perc)

    return loss_fn


@pytest.mark.parametrize("weights", ["teacher", "jax_init"])
def test_one_step_loss_and_gradients_match_jax(weights, teacher, jax_vgg_params):
    """``teacher``: the trained fixture (its confidence-map branch saturates
    on these inputs, so some tensors get exactly zero gradient on both
    sides); ``jax_init``: the JAX package's random init, where every tensor
    gets a gradient."""
    if weights == "teacher":
        params = teacher
    else:
        z = jnp.zeros((1, 32, 32, 3), jnp.float32)
        params = jax.tree.map(np.asarray, JaxWaterNet().init(jax.random.PRNGKey(0), z, z, z, z))
    views = _views()
    (loss, (mse, perc)), grads = jax.value_and_grad(
        _jax_loss_fn("fp32", jax_vgg_params, views), has_aux=True
    )(jax.tree.map(jnp.asarray, params))

    cfg = TrainConfig(batch_size=2, im_height=32, im_width=32, precision="fp32")
    engine = TrainingEngine(cfg, params=params, vgg_params=jax_vgg_params, device="cpu")
    t = [torch.from_numpy(v) for v in views]
    got_loss, _, aux = engine._losses_and_out(*t, torch.ones(2, dtype=torch.bool))
    got_loss.backward()
    for got, want in ((got_loss, loss), (aux["mse"], mse), (aux["perceptual_loss"], perc)):
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    assert float(perc) > 0

    want_g = state_dict_from_jax(jax.tree.map(np.asarray, grads))
    live = 0
    for name, p in engine.model.named_parameters():
        w = want_g[name].numpy()
        scale = np.abs(w).max()
        live += scale > 0
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-4 * scale, err_msg=name)
    assert live == (12 if weights == "teacher" else 34)
    # VGG is frozen: no gradient, no optimizer state.
    assert all(not p.requires_grad for p in engine.vgg.parameters())
    assert sum(p.numel() for g in engine.optimizer.param_groups for p in g["params"]) == 1_090_668


def test_bf16_step_loss_matches_jax_loosely(teacher, jax_vgg_params):
    views = _views(seed=1)
    want, _ = _jax_loss_fn("bf16", jax_vgg_params, views)(jax.tree.map(jnp.asarray, teacher))
    cfg = TrainConfig(batch_size=2, im_height=32, im_width=32, precision="bf16")
    engine = TrainingEngine(cfg, params=teacher, vgg_params=jax_vgg_params, device="cpu")
    got, out, _ = engine._losses_and_out(*(torch.from_numpy(v) for v in views), None)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=2e-2)


@pytest.fixture(scope="module")
def epoch_runs():
    """Two epochs of the JAX engine and the port's from the same initial
    parameters, dct8 cache, over 16 pairs (14 train / 2 val)."""
    kw = dict(batch_size=4, im_height=32, im_width=32, precision="fp32",
              perceptual_weight=0.0, augment=False, cache_codec="dct8")
    jds, ds = JaxPairs(16, 32, 32), SyntheticPairs(16, 32, 32)
    train_idx, val_idx = synthetic_split(16)
    jeng = JaxEngine(JaxConfig(**kw))
    init = jax.tree.map(np.asarray, jax.device_get(jeng.state.params))
    peng = TrainingEngine(TrainConfig(**kw), params=init, device="cpu")
    jeng.cache_dataset(jds, train_idx)
    peng.cache_dataset(ds, train_idx)
    runs = {"jax": [], "port": []}
    for epoch in range(2):
        runs["jax"].append((jeng.train_epoch_cached(epoch), jeng.eval_epoch_cached(jds, val_idx)))
        runs["port"].append((peng.train_epoch_cached(epoch), peng.eval_epoch_cached(ds, val_idx)))
    return runs, jeng, peng


@pytest.mark.parametrize("epoch", [0, 1])
@pytest.mark.parametrize("split", ["train", "val"])
def test_cached_epochs_track_jax(epoch_runs, epoch, split):
    runs, _, _ = epoch_runs
    part = 0 if split == "train" else 1
    want, got = runs["jax"][epoch][part], runs["port"][epoch][part]
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-6, err_msg=k)


def test_cache_resident_bytes_and_eval_over_train_cache(epoch_runs):
    _, jeng, peng = epoch_runs
    assert peng.cache_resident_bytes() == jeng.cache_resident_bytes() == codec.estimate_cache_bytes(
        "dct8", 14, 32, 32
    )
    m = peng.eval_epoch_cached()
    assert set(m) == set(trainer.VAL_METRICS_NAMES) and all(np.isfinite(list(m.values())))


def test_optimizer_is_adam_with_the_staircase_schedule():
    cfg = TrainConfig(lr_step=3)
    p = torch.nn.Parameter(torch.zeros(2))
    opt, sched = trainer.make_optimizer([p], cfg)
    assert opt.defaults["betas"] == (0.9, 0.999) and opt.defaults["eps"] == 1e-8
    lrs = []
    for _ in range(7):
        lrs.append(opt.param_groups[0]["lr"])
        p.grad = torch.ones(2)
        opt.step()
        sched.step()
    np.testing.assert_allclose(lrs, [1e-3] * 3 + [1e-4] * 3 + [1e-5])


def test_stamp_hook_sees_every_stage_and_changes_nothing():
    """``stage_profile --train`` times the engine's own step through its
    ``stamp`` hook: the hook sees each stage in order, and a stamped step
    gives the same metrics and parameters, bit for bit, as a plain one."""
    kw = dict(batch_size=2, im_height=16, im_width=16, precision="fp32", cache_codec="dct8")
    ds = SyntheticPairs(2, 16, 16)
    names, runs = [], []
    for extra in ({}, {"stamp": names.append}):
        engine = TrainingEngine(TrainConfig(**kw), device="cpu")
        engine.cache_dataset(ds, np.arange(2))
        step_fn, args = engine.cached_train_step()
        m = step_fn(*args, torch.arange(2), trainer.step_generator(0, 0, 0), 2, **extra)
        runs.append((m, engine.model.state_dict()))
    assert names == ["gather_decode", "preprocess", "forward", "losses", "backward",
                     "optimizer", "metrics"]
    (m0, sd0), (m1, sd1) = runs
    assert all(torch.equal(m0[k], m1[k]) for k in trainer.TRAIN_METRICS_NAMES)
    assert all(torch.equal(sd0[k], sd1[k]) for k in sd0)


def test_step_generator_depends_on_seed_epoch_and_batch():
    draws = {
        key: torch.rand(4, generator=trainer.step_generator(*key)).tolist()
        for key in ((0, 0, 0), (0, 0, 1), (0, 1, 0), (1, 0, 0))
    }
    assert len({tuple(v) for v in draws.values()}) == 4
    assert draws[(0, 0, 0)] == torch.rand(4, generator=trainer.step_generator(0, 0, 0)).tolist()


@pytest.mark.parametrize(
    "field",
    [dict(spatial_shards=2)],
    ids=lambda d: next(iter(d)),
)
def test_unported_fields_raise(field):
    """The fields that once raised NotImplementedError are ported: the
    config validates and builds an engine (spatial shards on the CPU's
    rehearsal layout; tests/test_torch_parallel.py holds its step)."""
    config = TrainConfig(**field, perceptual_weight=0.0)
    config.check_ported()
    engine = TrainingEngine(config, device="cpu")
    assert engine.devices == [torch.device("cpu")] * field["spatial_shards"]


@pytest.mark.parametrize("requested,env", [("raw", None), ("auto", None), ("auto", "10000000")])
def test_precache_histeq_with_raw_builds_tables(requested, env, monkeypatch):
    """TrainConfig's default precache_histeq with the raw codec (named, or
    resolved from ``auto``) builds the WB, GC and 8-variant CLAHE tables,
    and the cached step dispatches to the cached-pre step."""
    if env:
        monkeypatch.setenv("WATERNET_CACHE_HEADROOM_BYTES", env)
    engine = TrainingEngine(
        TrainConfig(batch_size=2, im_height=16, im_width=16, perceptual_weight=0.0,
                    cache_codec=requested), device="cpu",
    )
    engine.cache_dataset(SyntheticPairs(4, 16, 16), np.arange(4))
    assert engine.config.cache_codec == "raw"
    pre = engine._cache_pre
    assert pre["wb"].shape == pre["gc"].shape == (4, 16, 16, 3) and pre["he"].shape == (8, 4, 16, 16, 3)
    assert pre["vgg_ref"] is None
    assert engine.cached_train_step()[0] == engine.train_step_cached_pre


def test_auto_resolves_through_the_budgeter(monkeypatch):
    monkeypatch.setenv("WATERNET_CACHE_HEADROOM_BYTES", "60000")
    engine = TrainingEngine(
        TrainConfig(batch_size=4, im_height=32, im_width=32, perceptual_weight=0.0,
                    cache_codec="auto"), device="cpu",
    )
    engine.cache_dataset(SyntheticPairs(8, 32, 32), np.arange(8))
    assert engine.config.cache_codec == "yuv420"  # as tests/test_codec.py resolves it
    assert engine.cache_resident_bytes() == codec.estimate_cache_bytes("yuv420", 8, 32, 32)
    monkeypatch.setenv("WATERNET_CACHE_HEADROOM_BYTES", "1000")
    with pytest.raises(codec.CacheBudgetError):
        engine.cache_dataset(SyntheticPairs(8, 32, 32), np.arange(8))


def test_default_device_raises_without_cuda():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TrainingEngine(TrainConfig())


def _cli(args, tmp_path, env=None):
    return subprocess.run(
        [sys.executable, "-m", "waternet_tpu_torch.train", *args],
        cwd=REPO, capture_output=True, text=True, timeout=600, env=env,
    )


def test_train_cli_writes_the_artifacts_and_jax_loads_its_weights(tmp_path):
    from waternet_tpu.utils.checkpoint import load_weights as jax_load

    root = tmp_path / "runs"
    proc = _cli(
        ["--device", "cpu", "--synthetic", "16", "--epochs", "1", "--batch-size", "4",
         "--height", "32", "--width", "32", "--no-perceptual", "--precision", "fp32",
         "--device-cache", "--cache-codec", "dct8", "--train-root", str(root)],
        tmp_path,
    )
    assert proc.returncode == 0, proc.stderr
    assert "Device cache: codec=dct8 resident=21504 bytes" in proc.stdout
    run = root / "0"
    for name in ("last.npz", "metrics-train.csv", "metrics-val.csv", "summary.json", "config.json"):
        assert (run / name).is_file(), name
    config = json.loads((run / "config.json").read_text())
    assert config["cache_codec"] == "dct8"
    assert config["cache_resident_bytes"] == codec.estimate_cache_bytes("dct8", 14, 32, 32)
    header = (run / "metrics-train.csv").read_text().splitlines()[0]
    assert header == "mse,ssim,psnr,perceptual_loss,loss"
    assert (run / "metrics-val.csv").read_text().splitlines()[0] == "mse,ssim,psnr,perceptual_loss"
    stats = [json.loads(ln.split(" ", 1)[1]) for ln in proc.stdout.splitlines()
             if ln.startswith("epoch_stats ")]
    assert len(stats) == 1 and stats[0]["steps"] == 4

    params = jax_load(run / "last.npz")
    x = np.random.default_rng(0).random((4, 2, 24, 24, 3)).astype(np.float32)
    want = np.asarray(JaxWaterNet().apply(params, *(jnp.asarray(a) for a in x)))
    from waternet_tpu_torch.models import WaterNet

    model = WaterNet()
    model.load_state_dict(state_dict_from_jax(load_weights(run / "last.npz")))
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize(
    "args,needle",
    [
        (["--synthetic", "8", "--cache-codec", "dct8"], "requires --device-cache"),
        (["--synthetic", "8", "--host-preprocess", "--device-preprocess"], "mutually exclusive"),
        (["--synthetic", "8", "--device-cache", "--host-preprocess"], "requires device preprocessing"),
        (["--synthetic", "8", "--tensorboard"], "--tensorboard needs the 'tensorboard' package"),
        (["--synthetic", "8", "--checkpoint-every", "soon"], "--checkpoint-every: want N, Ns or Nm"),
    ],
    # The ids the cases had when --tensorboard was a stub naming its ROADMAP
    # item; it is ported now, and refuses only where tensorboard is missing.
    ids=["args0-requires --device-cache", "args1-mutually exclusive", "args2-requires device preprocessing",
         "args3-ROADMAP Queue A item 9", "args4---checkpoint-every: want N, Ns or Nm"],
)
def test_train_cli_refuses_what_is_not_ported(args, needle, tmp_path):
    env = None
    if "--tensorboard" in args:
        # A package named tensorboard that does not import, ahead of the real one.
        shadow = tmp_path / "shadow" / "tensorboard"
        shadow.mkdir(parents=True)
        (shadow / "__init__.py").write_text("raise ImportError('tensorboard is hidden from this run')\n")
        env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(shadow.parent), str(REPO)])}
    proc = _cli([*args, "--device", "cpu"], tmp_path, env=env)
    assert proc.returncode == 2 and needle in proc.stderr


def test_train_cli_cache_report(tmp_path):
    proc = _cli(["--synthetic", "64", "--height", "256", "--width", "256", "--cache-report",
                 "--device", "cpu"], tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[0].startswith("device-cache budget (headroom: unknown")
    assert [ln.split()[0] for ln in proc.stdout.splitlines()[2:]] == list(codec.CODECS)
