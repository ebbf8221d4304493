"""Distillation in the port (``TrainConfig.distill``, ``train --distill``):
the CAN student trained against a frozen WaterNet teacher whose output
replaces the reference in every loss and metric.

Bounds: the committed fixture pair (tests/fixtures/distill, produced by
the JAX package's recipe in tools/distill_fixture.py) evaluates at SSIM >=
0.90 and PSNR >= 30 student-against-teacher on the port, as
tests/test_distill.py pins it for JAX; one fp32 distill step from the same
parameters and batch as JAX's: the loss within rel 1e-5 and every gradient
within atol 1e-4 x its largest magnitude (tests/test_torch_trainer.py's
bound for the WaterNet step).
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from waternet_tpu.models import CANStudent as JaxCANStudent
from waternet_tpu.models import WaterNet as JaxWaterNet
from waternet_tpu.models.vgg import VGG19Features as JaxVGG
from waternet_tpu.models.vgg import init_vgg_params as jax_init_vgg
from waternet_tpu.training import losses as jlosses
from waternet_tpu.utils.checkpoint import load_weights as jax_load_weights
from waternet_tpu_torch.data.synthetic import SyntheticPairs
from waternet_tpu_torch.inference_engine import StudentEngine
from waternet_tpu_torch.models.can import train_flops_per_image
from waternet_tpu_torch.ops.fused import fused_train_preprocess
from waternet_tpu_torch.training.trainer import TrainConfig, TrainingEngine
from waternet_tpu_torch.utils.checkpoint import load_weights
from waternet_tpu_torch.utils.convert import can_state_dict_from_jax

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from tools.distill_fixture import HW, N_IMAGES, SEED, STUDENT_DEPTH, STUDENT_WIDTH  # noqa: E402

FIXTURES = REPO / "tests" / "fixtures" / "distill"
TEACHER = FIXTURES / "teacher.npz"
STUDENT = FIXTURES / "student.npz"
SSIM_VS_TEACHER_FLOOR = 0.90  # tests/test_distill.py:42


@pytest.fixture(scope="module")
def pair():
    return load_weights(TEACHER), load_weights(STUDENT)


@pytest.fixture(scope="module")
def data():
    return SyntheticPairs(N_IMAGES, HW, HW, seed=SEED)


def _config(**over):
    kw = dict(batch_size=N_IMAGES, im_height=HW, im_width=HW, precision="fp32", perceptual_weight=0.0,
              augment=False, seed=SEED, distill=True, student_width=STUDENT_WIDTH, student_depth=STUDENT_DEPTH)
    kw.update(over)
    return TrainConfig(**kw)


def test_fixture_student_tracks_its_teacher(pair, data):
    """The committed distilled student against its teacher on the port:
    val SSIM >= 0.90 and PSNR >= 30 (in distill mode val ssim/psnr ARE
    student-against-teacher)."""
    teacher, student = pair
    eng = TrainingEngine(_config(), params=student, teacher_params=teacher, device="cpu")
    val = eng.eval_epoch(data.batches(np.arange(N_IMAGES), N_IMAGES, shuffle=False))
    assert val["ssim"] >= SSIM_VS_TEACHER_FLOOR and val["psnr"] >= 30.0, val


def test_metrics_track_the_teacher_not_the_reference(pair, data):
    teacher, student = pair
    eng = TrainingEngine(_config(), params=student, teacher_params=teacher, device="cpu")
    idx = np.arange(N_IMAGES)
    real = eng.eval_epoch(data.batches(idx, N_IMAGES, shuffle=False))
    rng = np.random.default_rng(0)
    garbage = eng.eval_epoch(
        (raw, rng.integers(0, 256, ref.shape, dtype=np.uint8)) for raw, ref in data.batches(idx, N_IMAGES, shuffle=False)
    )
    for k in ("mse", "ssim", "psnr"):
        assert real[k] == pytest.approx(garbage[k]), k


def test_loss_falls_over_a_few_epochs(pair, data):
    teacher, _ = pair
    eng = TrainingEngine(_config(lr=3e-3), teacher_params=teacher, device="cpu")
    idx = np.arange(N_IMAGES)
    losses = [eng.train_epoch(data.batches(idx, N_IMAGES, shuffle=True, seed=SEED, epoch=e), epoch=e)["loss"]
              for e in range(8)]
    assert np.isfinite(losses[-1]) and losses[-1] < 0.5 * losses[0], losses


def test_one_fp32_distill_step_matches_jax(pair):
    """The same student, teacher, VGG and batch through one fp32 step of
    each package, perceptual term on: the loss, its parts and every
    student gradient."""
    teacher, student = pair
    jteacher, jstudent = jax_load_weights(TEACHER), jax_load_weights(STUDENT)
    vgg_params = jax.tree.map(np.asarray, jax_init_vgg())
    ds = SyntheticPairs(2, 32, 32, seed=3)
    raw, ref = (torch.from_numpy(np.stack(a)) for a in zip(*(ds.load_pair(i) for i in range(2))))
    with torch.no_grad():
        views = [t.numpy() for t in fused_train_preprocess(raw, ref, None, augment=False)]

    x, wbn, hen, gcn, _ = (jnp.asarray(v) for v in views)
    target = jax.lax.stop_gradient(JaxWaterNet().apply(jteacher, x, wbn, hen, gcn))
    vgg = JaxVGG()

    def loss_fn(params):
        out = JaxCANStudent(width=STUDENT_WIDTH, depth=STUDENT_DEPTH).apply(params, x)
        mse = jlosses.mse_255(out, target)
        perc = jlosses.perceptual_loss(vgg, vgg_params, out, target)
        return jlosses.PERCEPTUAL_WEIGHT * perc + mse, (mse, perc)

    (loss, (mse, perc)), grads = jax.value_and_grad(loss_fn, has_aux=True)(jax.tree.map(jnp.asarray, jstudent))

    cfg = _config(batch_size=2, im_height=32, im_width=32, perceptual_weight=0.05)
    eng = TrainingEngine(cfg, params=student, vgg_params=vgg_params, teacher_params=teacher, device="cpu")
    got_loss, _, aux = eng._losses_and_out(*(torch.from_numpy(v) for v in views), torch.ones(2, dtype=torch.bool))
    got_loss.backward()
    for got, want in ((got_loss, loss), (aux["mse"], mse), (aux["perceptual_loss"], perc)):
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    assert float(perc) > 0
    want_g = can_state_dict_from_jax(jax.tree.map(np.asarray, grads))
    for name, p in eng.model.named_parameters():
        w = want_g[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=name)
    # Only the student trains: the teacher is frozen and holds no optimizer state.
    assert all(not p.requires_grad for p in eng.teacher.parameters())
    n_student = sum(p.numel() for p in eng.model.parameters())
    assert sum(p.numel() for g in eng.optimizer.param_groups for p in g["params"]) == n_student


def test_distill_flops_and_state(pair, tmp_path):
    teacher, _ = pair
    eng = TrainingEngine(_config(), teacher_params=teacher, device="cpu")
    assert eng.perf.flops_per_image == train_flops_per_image(HW, HW, STUDENT_WIDTH, STUDENT_DEPTH, distill=True)
    eng.checkpoint(tmp_path / "state")
    other = TrainingEngine(_config(seed=5), teacher_params=teacher, device="cpu")
    other.restore(tmp_path / "state")
    for a, b in zip(eng.model.state_dict().values(), other.model.state_dict().values()):
        assert torch.equal(a, b)


def test_distill_guards(pair):
    teacher, _ = pair
    with pytest.raises(ValueError, match="teacher weights"):
        TrainingEngine(_config(), device="cpu")
    with pytest.raises(ValueError, match="data parallelism only"):
        TrainingEngine(_config(spatial_shards=2), teacher_params=teacher, device="cpu")
    eng = TrainingEngine(_config(precache_vgg_ref=True, perceptual_weight=0.05), teacher_params=teacher, device="cpu")
    with pytest.raises(ValueError, match="incompatible with distill"):
        eng.cache_dataset(SyntheticPairs(2, HW, HW, seed=0), np.arange(2))


def test_distill_on_the_raw_cache_with_precache_tables(pair):
    """The cached step with the precache tables (the --device-cache
    default) feeds the teacher the gathered WB/GC/CLAHE planes: the epoch
    equals the host-fed epoch's metrics on the same batches."""
    teacher, student = pair
    ds = SyntheticPairs(4, 24, 24, seed=1)
    kw = dict(batch_size=4, im_height=24, im_width=24, shuffle=False)
    cached = TrainingEngine(_config(**kw), params=student, teacher_params=teacher, device="cpu")
    cached.cache_dataset(ds, np.arange(4))
    assert cached._cache_pre is not None
    m_cached = cached.train_epoch_cached(0)
    fed = TrainingEngine(_config(**kw), params=student, teacher_params=teacher, device="cpu")
    m_fed = fed.train_epoch(ds.batches(np.arange(4), 4, shuffle=False), 0)
    for k in ("mse", "ssim", "psnr", "loss"):
        assert m_cached[k] == pytest.approx(m_fed[k], rel=1e-6), k


def _cli(args):
    return subprocess.run([sys.executable, "-m", "waternet_tpu_torch.train", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=600)


def test_cli_makes_a_student_the_fast_tier_serves(tmp_path):
    root = tmp_path / "runs"
    proc = _cli(["--device", "cpu", "--distill", "--teacher-weights", str(TEACHER), "--student-width", "8",
                 "--student-depth", "4", "--synthetic", "8", "--val-size", "4", "--batch-size", "4", "--height",
                 "24", "--width", "24", "--epochs", "2", "--no-perceptual", "--precision", "fp32", "--workers",
                 "0", "--train-root", str(root)])
    assert proc.returncode == 0, proc.stderr
    run = next(root.iterdir())
    cfg = json.loads((run / "config.json").read_text())
    assert cfg["distill"] is True and (cfg["student_width"], cfg["student_depth"]) == (8, 4)
    eng = StudentEngine(weights=str(run / "last.npz"), device="cpu")
    assert (eng.width, eng.depth) == (8, 4)
    out = eng.enhance(np.zeros((1, 24, 24, 3), np.uint8))
    assert out.shape == (1, 24, 24, 3) and out.dtype == np.uint8
    # JAX's engine serves the same checkpoint.
    from waternet_tpu.inference_engine import StudentEngine as JaxStudentEngine

    assert JaxStudentEngine(weights=str(run / "last.npz")).depth == 4
    losses = [json.loads(ln[len("epoch_stats "):])["train"]["loss"] for ln in proc.stdout.splitlines()
              if ln.startswith("epoch_stats ")]
    assert len(losses) == 2 and all(np.isfinite(losses))


@pytest.mark.parametrize("args,needle", [
    (["--distill", "--precache-vgg-ref", "--device-cache"], "incompatible with --distill"),
    (["--teacher-weights", "t.npz"], "--teacher-weights needs --distill"),
])
def test_cli_flag_conflicts(args, needle):
    proc = _cli(["--device", "cpu", "--synthetic", "2", "--epochs", "1", *args])
    assert proc.returncode == 2 and needle in proc.stderr
