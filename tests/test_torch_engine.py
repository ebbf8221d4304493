"""The port's serving slice end to end on the CPU, against the JAX package:
``InferenceEngine`` (device- and host-preprocess, fp32 and bf16), the hub
triple, the inference CLI, the CUDA-by-default rule, and the import
boundary.

Tolerance: the fp32 engines' uint8 outputs agree within one level, on a
small share of pixels. The fp32 forwards differ by float rounding (~1e-6)
and the device path's LAB inverse may differ by one level on a few pixels,
either of which can move a truncated uint8 output by one. The bf16
engines (bf16 autocast against flax's ``dtype=bfloat16``) agree within 3
levels, and by more than one level on at most 1% of values: the two
frameworks round the bf16 convolutions' products and activations in other
places.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waternet_tpu.hub import waternet as jax_waternet
from waternet_tpu.inference_engine import InferenceEngine as JaxEngine
from waternet_tpu_torch.hub import waternet
from waternet_tpu_torch.inference_engine import InferenceEngine
from waternet_tpu_torch.utils.checkpoint import load_weights
from waternet_tpu_torch.utils.convert import state_dict_from_jax

REPO = Path(__file__).resolve().parent.parent
TEACHER = str(REPO / "tests" / "fixtures" / "distill" / "teacher.npz")
SHAPES = [(2, 40, 56, 3), (1, 37, 53, 3)]


def frames(shape, seed):
    """Smooth fields plus noise, so WB and CLAHE see photo-like histograms."""
    rng = np.random.default_rng(seed)
    n, h, w, _ = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack(
        [50 + 40 * np.sin(xx / 7 + c) + 30 * np.cos(yy / 5 + 2 * c) + 50 * c for c in range(3)],
        axis=-1,
    )
    return np.clip(base + rng.normal(0, 12, (n, h, w, 3)), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def engines():
    return {
        dp: (
            InferenceEngine(weights=TEACHER, device_preprocess=dp, device="cpu"),
            JaxEngine(weights=TEACHER, device_preprocess=dp),
        )
        for dp in (True, False)
    }


def assert_within_one_level(got, want):
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.01


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("device_preprocess", [True, False], ids=["devpre", "hostpre"])
def test_engine_matches_jax_engine(engines, shape, device_preprocess):
    port, ref = engines[device_preprocess]
    batch = frames(shape, seed=shape[1])
    assert_within_one_level(port.enhance(batch), ref.enhance(batch))


@pytest.fixture(scope="module")
def bf16_engines():
    return {
        dp: (
            InferenceEngine(weights=TEACHER, device_preprocess=dp, device="cpu", dtype=torch.bfloat16),
            JaxEngine(weights=TEACHER, device_preprocess=dp, dtype=jnp.bfloat16),
        )
        for dp in (True, False)
    }


def assert_within_bf16_bound(got, want):
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 3
    assert (diff > 1).mean() <= 0.01


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("device_preprocess", [True, False], ids=["devpre", "hostpre"])
def test_bf16_engine_matches_jax_bf16_engine(bf16_engines, shape, device_preprocess):
    port, ref = bf16_engines[device_preprocess]
    batch = frames(shape, seed=shape[1])
    assert_within_bf16_bound(port.enhance(batch), ref.enhance(batch))


@pytest.mark.parametrize("device_preprocess", [True, False], ids=["devpre", "hostpre"])
def test_bf16_enhance_async_returns_float32_on_the_engine_device(bf16_engines, device_preprocess):
    port, _ = bf16_engines[device_preprocess]
    out = port.enhance_async(frames((2, 16, 24, 3), 1))
    assert out.shape == (2, 16, 24, 3) and out.dtype == torch.float32
    assert out.device.type == "cpu"


def test_bf16_autocast_stops_at_the_model(bf16_engines, engines, monkeypatch):
    """The bf16 device-preprocess engine's transforms run outside autocast
    and equal the fp32 engine's bit for bit."""
    import waternet_tpu_torch.inference_engine as ie

    seen = []

    def recording(rgb):
        out = ie_transform(rgb)
        seen.append((torch.is_autocast_enabled("cpu"), [t.clone() for t in out]))
        return out

    ie_transform = ie.transform_batch
    monkeypatch.setattr(ie, "transform_batch", recording)
    batch = frames((2, 40, 56, 3), 11)
    bf16_engines[True][0].enhance(batch)
    engines[True][0].enhance(batch)
    (on_bf16, got), (on_fp32, want) = seen
    assert not on_bf16 and not on_fp32
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert torch.equal(g, w)


def test_engine_and_hub_refuse_other_dtypes():
    with pytest.raises(ValueError, match="torch.float32 or torch.bfloat16"):
        InferenceEngine(weights=TEACHER, device="cpu", dtype=torch.float16)
    with pytest.raises(ValueError, match="torch.float32 or torch.bfloat16"):
        waternet(weights=TEACHER, device="cpu", dtype=torch.float64)


def test_bf16_hub_matches_jax_bf16_hub():
    pre, post, model = waternet(weights=TEACHER, device="cpu", dtype=torch.bfloat16)
    jpre, jpost, jmodel = jax_waternet(weights=TEACHER, dtype=jnp.bfloat16)
    rgb = frames((1, 32, 40, 3), 6)[0]
    with torch.inference_mode():
        out = model(*pre(rgb))
    assert out.dtype == torch.float32
    assert_within_bf16_bound(post(out), jpost(jmodel(*jpre(rgb))))


def test_enhance_async_returns_nhwc_float_on_the_engine_device(engines):
    port, _ = engines[True]
    out = port.enhance_async(frames((1, 16, 24, 3), 0))
    assert out.shape == (1, 16, 24, 3) and out.dtype == torch.float32
    assert out.device.type == "cpu"
    with pytest.raises(ValueError, match="empty batch"):
        port.enhance_async(np.zeros((0, 8, 8, 3), np.uint8))


def test_engine_accepts_a_loaded_state_dict(engines):
    port, _ = engines[False]
    sd = state_dict_from_jax(load_weights(TEACHER))
    other = InferenceEngine(params=sd, device="cpu")
    batch = frames((1, 24, 32, 3), 3)
    np.testing.assert_array_equal(other.enhance(batch), port.enhance(batch))


def test_hub_triple_matches_jax_hub():
    pre, post, model = waternet(weights=TEACHER, device="cpu")
    jpre, jpost, jmodel = jax_waternet(weights=TEACHER)
    rgb = frames((1, 32, 40, 3), 5)[0]
    inputs = pre(rgb)
    assert [tuple(t.shape) for t in inputs] == [(1, 32, 40, 3)] * 4
    with torch.inference_mode():
        got = post(model(*inputs))
    assert_within_one_level(got, jpost(jmodel(*jpre(rgb))))


def test_cuda_is_the_default_and_never_falls_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(weights=TEACHER)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        waternet(weights=TEACHER)


def test_inference_cli_writes_one_output_per_image(tmp_path):
    import cv2

    src = tmp_path / "in"
    src.mkdir()
    shapes = [(24, 32), (24, 32), (20, 28)]
    for i, (h, w) in enumerate(shapes):
        cv2.imwrite(str(src / f"im{i}.png"), frames((1, h, w, 3), i)[0])
    out_root = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "waternet_tpu_torch.inference", "--source", str(src),
         "--weights", TEACHER, "--device", "cpu", "--device-preprocess",
         "--batch-size", "4", "--output-root", str(out_root)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    written = sorted((out_root / "0").glob("*.png"))
    assert [p.name for p in written] == ["im0.png", "im1.png", "im2.png"]
    for p, (h, w) in zip(written, shapes):
        assert cv2.imread(str(p)).shape == (h, w, 3)


def test_port_imports_no_jax_and_no_jax_package():
    """Every module of the port, and chip_smoke.py, import in a fresh
    interpreter without pulling in jax, flax, optax, cv2 or waternet_tpu."""
    code = """
import importlib, pkgutil, sys
import waternet_tpu_torch
for m in pkgutil.walk_packages(waternet_tpu_torch.__path__, "waternet_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
for name in ("data.pipeline", "data.uieb", "training.metrics_nr", "score", "data.video",
             "metrics.flicker", "inference", "serving.server", "serving.batcher",
             "serving.replicas", "ops.masked", "models.can", "models.quant", "export",
             "serving.streams", "serving.fleet", "obs.cli", "parallel.mesh", "parallel.spatial",
             "parallel.distributed", "resilience.supervisor"):
    assert "waternet_tpu_torch." + name in sys.modules, name
bad = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "cv2", "waternet_tpu")
)
assert not bad, bad
from waternet_tpu_torch import export
assert callable(export.main)  # the export CLI, python -m waternet_tpu_torch.export
print(len([m for m in sys.modules if m.startswith("waternet_tpu_torch")]))
"""
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 30
