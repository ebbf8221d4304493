"""The port's scorer (``python -m waternet_tpu_torch.score``), its
no-reference metrics (``training/metrics_nr.py``) and the header-only
shape reader (``utils/imagemeta.py``) against the JAX package, on the CPU.

Tolerances: UCIQE/UIQM of the same image within 1e-4 (float32 sorts,
quantiles and means, reduced in other orders); the scorer's metric dicts,
key for key, within rel 1e-3 of the JAX ``score.py`` on the same tree and
weights (the committed ``teacher.npz``; the paired mode's perceptual term
under the JAX package's VGG19 random init, saved as an ``.npz`` both
packages load), the tolerance of the trainer's JAX comparisons;
``image_shape`` exactly."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import score as jax_score
from waternet_tpu.models.vgg import init_vgg_params as jax_init_vgg
from waternet_tpu.training import metrics_nr as jax_nr
from waternet_tpu.utils.checkpoint import save_weights as jax_save_weights
from waternet_tpu.utils.imagemeta import image_shape as jax_image_shape
from waternet_tpu_torch import score as port_score
from waternet_tpu_torch.training import metrics_nr
from waternet_tpu_torch.utils.imagemeta import image_shape
from waternet_tpu_torch.utils.synthetic import photo_frames
from tests.test_torch_uieb import write_uieb_tree

REPO = Path(__file__).resolve().parent.parent
TEACHER = str(REPO / "tests" / "fixtures" / "distill" / "teacher.npz")


@pytest.mark.parametrize("shape", [(2, 37, 53), (1, 64, 96), (1, 251, 333)])
def test_nr_metrics_match_jax(shape):
    rng = np.random.default_rng(shape[1])
    ims = np.concatenate([photo_frames(rng, *shape), rng.integers(0, 256, (1, *shape[1:], 3), dtype=np.uint8)])
    for name in ("uciqe", "uiqm"):
        want = np.asarray(getattr(jax_nr, f"{name}_batch")(jnp.asarray(ims)))
        got = getattr(metrics_nr, f"{name}_batch")(torch.from_numpy(ims))
        assert got.shape == (len(ims),) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4, err_msg=name)


def test_image_shape_matches_jax(tmp_path):
    import cv2

    img = photo_frames(np.random.default_rng(0), 1, 21, 34)[0]
    for suffix in (".png", ".jpg", ".bmp"):
        path = tmp_path / f"a{suffix}"
        cv2.imwrite(str(path), img)
        assert image_shape(path) == jax_image_shape(path) == (21, 34, 3)
    (tmp_path / "junk.png").write_bytes(b"not an image")
    assert image_shape(tmp_path / "junk.png") is None is jax_image_shape(tmp_path / "junk.png")


@pytest.fixture(scope="module")
def scoring_tree(tmp_path_factory):
    """A 10-pair UIEB tree at 40x48, a raw-only directory holding its raws
    plus three images at another shape, and the JAX VGG init as an npz."""
    import cv2

    root = tmp_path_factory.mktemp("score")
    tree = write_uieb_tree(root / "uieb", n=10)
    raw_dir = root / "raw"
    raw_dir.mkdir()
    for p in (tree / "raw-890").glob("*.png"):
        (raw_dir / p.name).write_bytes(p.read_bytes())
    for i, im in enumerate(photo_frames(np.random.default_rng(5), 3, 36, 52)):
        cv2.imwrite(str(raw_dir / f"other{i}.png"), im)
    vgg = root / "vgg19_jax.npz"
    jax_save_weights(jax.tree.map(np.asarray, jax_init_vgg()), vgg)
    return tree, raw_dir, vgg


def _both(argv, tmp_path):
    out = {}
    for name, main, extra in (("jax", jax_score.main, []), ("port", port_score.main, ["--device", "cpu"])):
        path = tmp_path / f"{name}.json"
        main([*argv, "--weights", TEACHER, "--json-out", str(path), *extra])
        out[name] = json.loads(path.read_text())
    return out["port"], out["jax"]


PAIRED = {
    "host-val": ["--split", "val"],
    "device-all-sync": ["--split", "all", "--device-preprocess", "--workers", "0"],
    "bug-compat": ["--split", "all", "--bug-compat-perceptual"],
}


@pytest.mark.parametrize("case", list(PAIRED))
def test_paired_scores_match_jax(case, scoring_tree, tmp_path):
    tree, _, vgg = scoring_tree
    argv = ["--data-root", str(tree), "--val-size", "4", "--height", "32", "--width", "32",
            "--batch-size", "4", "--vgg-weights", str(vgg), *PAIRED[case]]
    got, want = _both(argv, tmp_path)
    assert list(got) == list(want) == ["mse", "ssim", "psnr", "perceptual_loss"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=k)
    assert want["perceptual_loss"] > 0


@pytest.mark.parametrize("resize", [False, True], ids=["native", "nr-resize"])
def test_no_reference_scores_match_jax(resize, scoring_tree, tmp_path):
    _, raw_dir, _ = scoring_tree
    argv = ["--raw-dir", str(raw_dir), "--batch-size", "4", "--height", "32", "--width", "32"]
    got, want = _both(argv + (["--nr-resize"] if resize else []), tmp_path)
    assert list(got) == list(want) and got["images"] == want["images"] == 13
    for k in ("uciqe_raw", "uiqm_raw", "uciqe_enhanced", "uiqm_enhanced"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=k)


def test_score_cli_runs_as_a_module(scoring_tree, tmp_path):
    _, raw_dir, _ = scoring_tree
    out = tmp_path / "m.json"
    proc = subprocess.run(
        [sys.executable, "-m", "waternet_tpu_torch.score", "--device", "cpu", "--weights", TEACHER,
         "--raw-dir", str(raw_dir), "--json-out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    metrics = json.loads(out.read_text())
    assert metrics["images"] == 13 and all(np.isfinite(v) for v in metrics.values())
    assert "Scored 13 raw images" in proc.stdout
