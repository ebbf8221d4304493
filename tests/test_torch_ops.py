"""Port classical ops (waternet_tpu_torch.ops) against the JAX device path
and cv2, on the CPU, at shapes that do and do not divide the 8x8 tile grid.

Tolerances: gamma, white balance, the uint8 LAB forward and CLAHE are
bit-exact (integer pipelines, or float32 ops in one order). The float LAB
inverse, and so ``histeq`` and ``transform_batch``'s ``he``, may differ by
one level on a few pixels: XLA's CPU code may fuse the inverse's
multiply-add chain into FMAs (differently per vector and remainder loop),
torch's eager ops round each step.

CLAHE and ``histeq`` are compared with the JAX functions run op by op, as
the JAX package's own cv2-parity tests run them. Under ``jax.jit`` XLA
fuses CLAHE's blend into FMAs and moves L by one level on ~0.2% of the
pixels of frames whose size the tile grid does not divide; the port, like
op-by-op JAX, matches cv2 exactly.
"""

import numpy as np
import pytest
import torch

import cv2
import jax
import jax.numpy as jnp

from waternet_tpu.ops.clahe import clahe as jax_clahe
from waternet_tpu.ops.clahe import histeq as jax_histeq
from waternet_tpu.ops.color import lab_u8_to_rgb as jax_lab_to_rgb
from waternet_tpu.ops.color import rgb_to_lab_u8 as jax_rgb_to_lab
from waternet_tpu.ops.gamma import gamma_correction as jax_gamma
from waternet_tpu.ops.transform import transform_batch as jax_transform_batch
from waternet_tpu.ops.transform import transform_np as jax_transform_np
from waternet_tpu.ops.wb import white_balance as jax_wb
from waternet_tpu_torch.ops.clahe import clahe, histeq
from waternet_tpu_torch.ops.color import lab_u8_to_rgb, rgb_to_lab_u8
from waternet_tpu_torch.ops.gamma import gamma_correction
from waternet_tpu_torch.ops.transform import transform_batch, transform_np
from waternet_tpu_torch.ops.wb import white_balance

SHAPES = [(37, 53), (64, 64), (100, 30)]


def photo(seed, n, h, w):
    """(n, h, w, 3) uint8: smooth sinusoid fields per channel plus noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for _ in range(n):
        ph = rng.uniform(0, 6.3, 6)
        base = np.stack(
            [
                60 + 40 * np.sin(xx / 9 + ph[0]) + 30 * np.cos(yy / 7 + ph[1]),
                100 + 50 * np.sin(xx / 13 + ph[2]) + 20 * np.cos(yy / 5 + ph[3]),
                130 + 60 * np.sin(xx / 11 + ph[4]) + 25 * np.cos(yy / 17 + ph[5]),
            ],
            axis=-1,
        )
        out.append(np.clip(base + rng.normal(0, 12, base.shape), 0, 255))
    return np.stack(out).astype(np.uint8)


def per_image(fn, batch):
    return np.stack([np.asarray(fn(jnp.asarray(im))) for im in batch])


_JAX_CACHE = {}


def jax_transform(batch):
    """The JAX device path's (wb, gc, he) for ``batch``, once per test
    process: wb and gc from the jitted ``transform_batch``, he from
    ``histeq`` op by op (see the module docstring)."""
    key = ("transform", batch.tobytes())
    if key not in _JAX_CACHE:
        wb, gc, _ = jax.jit(jax_transform_batch)(jnp.asarray(batch))
        he = per_image(jax_histeq, batch)
        _JAX_CACHE[key] = (np.asarray(wb), np.asarray(gc), he)
    return _JAX_CACHE[key]


def jax_clahe_batch(lum):
    key = ("clahe", lum.tobytes())
    if key not in _JAX_CACHE:
        _JAX_CACHE[key] = per_image(jax_clahe, lum.astype(np.float32))
    return _JAX_CACHE[key]


@pytest.fixture(params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def batch(request):
    h, w = request.param
    return photo(h * 1000 + w, 2, h, w)


def test_gamma_bitexact(batch):
    got = gamma_correction(torch.from_numpy(batch)).numpy()
    np.testing.assert_array_equal(got, jax_transform(batch)[1])
    np.testing.assert_array_equal(got[0], np.asarray(jax_gamma(jnp.asarray(batch[0]))))


def test_white_balance_bitexact(batch):
    got = white_balance(torch.from_numpy(batch)).numpy()
    np.testing.assert_array_equal(got, jax_transform(batch)[0])


@pytest.mark.parametrize("case", ["black_channel", "constant", "black"])
def test_white_balance_degenerate_frames_bitexact(case):
    im = photo(7, 1, 20, 24)
    if case == "black_channel":
        im[..., 2] = 0
    elif case == "constant":
        im[:] = 77
    else:
        im[:] = 0
    got = white_balance(torch.from_numpy(im)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, per_image(jax_wb, im))


def test_rgb_to_lab_u8_bitexact_vs_jax_and_cv2(batch):
    got = rgb_to_lab_u8(torch.from_numpy(batch)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_rgb_to_lab(jnp.asarray(batch))))
    cv = np.stack([cv2.cvtColor(im, cv2.COLOR_RGB2LAB) for im in batch])
    np.testing.assert_array_equal(got, cv.astype(np.float32))


def test_rgb_to_lab_u8_bitexact_on_the_whole_cube_sample():
    """Every 4th level per channel: 262,144 colours, vs cv2."""
    lv = np.arange(0, 256, 4, dtype=np.uint8)
    cube = np.stack(np.meshgrid(lv, lv, lv, indexing="ij"), -1).reshape(512, 512, 3)
    got = rgb_to_lab_u8(torch.from_numpy(cube)).numpy()
    np.testing.assert_array_equal(got, cv2.cvtColor(cube, cv2.COLOR_RGB2LAB))


@pytest.mark.parametrize("use_kernels", [True, False], ids=["wrapper", "plain"])
def test_clahe_bitexact_vs_jax_and_cv2(batch, use_kernels):
    """CLAHE on L through the kernel wrappers (which take the plain versions
    for CPU tensors) and through the plain versions named directly: bit for
    bit the JAX device path and cv2.createCLAHE."""
    lum = np.stack([cv2.cvtColor(im, cv2.COLOR_RGB2LAB)[..., 0] for im in batch])
    got = clahe(torch.from_numpy(lum), use_kernels=use_kernels).numpy()
    np.testing.assert_array_equal(got, jax_clahe_batch(lum))
    op = cv2.createCLAHE(clipLimit=0.1, tileGridSize=(8, 8))
    want = np.stack([op.apply(l) for l in lum])
    np.testing.assert_array_equal(got, want.astype(np.float32))


@pytest.mark.parametrize(
    "hw,grid", [((19, 23), (3, 4)), ((33, 17), (5, 3)), ((40, 56), (4, 7)), ((5, 7), (8, 8))]
)
def test_clahe_other_tile_grids_and_tiny_images_bitexact_vs_cv2(hw, grid):
    """Odd tile grids, single-axis divisibility and a frame smaller than the
    grid, against cv2 (the oracle the JAX path is pinned to)."""
    rng = np.random.default_rng(hw[0] * 31 + hw[1])
    lum = rng.integers(0, 256, size=(2, *hw)).astype(np.uint8)
    got = clahe(torch.from_numpy(lum), tile_grid=grid).numpy()
    op = cv2.createCLAHE(clipLimit=0.1, tileGridSize=(grid[1], grid[0]))
    np.testing.assert_array_equal(got, np.stack([op.apply(l) for l in lum]).astype(np.float32))


@pytest.mark.parametrize("use_kernels", [True, False], ids=["wrapper", "plain"])
def test_clahe_interpolates_through_the_fused_blend_once(monkeypatch, use_kernels):
    """clahe() makes one call of the fused lookup-and-blend (the wrapper, or
    its plain version when asked), none of the four-plane wrapper, and
    hands it the host-made weights; on a CPU tensor the wrapper's plain
    version does the lookup and the eager blend."""
    from waternet_tpu_torch.ops import kernels

    calls = []
    name = "clahe_lut_blend" if use_kernels else "clahe_lut_blend_plain"
    real = getattr(kernels, name)

    def spy(*args):
        calls.append(args)
        return real(*args)

    def refuse(*_):
        raise AssertionError("the unfused path ran")

    monkeypatch.setattr(kernels, name, spy)
    monkeypatch.setattr(kernels, "clahe_lut_planes", refuse)
    lum = photo(3, 2, 37, 53)[..., 0]
    got = clahe(torch.from_numpy(lum), use_kernels=use_kernels)
    assert len(calls) == 1 and got.shape == (2, 37, 53)
    ya, xa, h, w = calls[0][-4:]
    assert (h, w) == (37, 53) and ya.shape == (37, 1) and xa.shape == (1, 53)
    op = cv2.createCLAHE(clipLimit=0.1, tileGridSize=(8, 8))
    want = np.stack([op.apply(l) for l in lum]).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_lab_u8_to_rgb_within_one_level(batch):
    lab = np.array(jax_rgb_to_lab(jnp.asarray(batch)))
    got = lab_u8_to_rgb(torch.from_numpy(lab)).numpy()
    want = np.asarray(jax_lab_to_rgb(jnp.asarray(lab)))
    diff = np.abs(got - want)
    assert diff.max() <= 1.0
    assert (diff > 0).mean() < 0.01


def test_histeq_within_one_level(batch):
    got = histeq(torch.from_numpy(batch)).numpy()
    want = jax_transform(batch)[2]
    diff = np.abs(got - want)
    assert diff.max() <= 1.0
    assert (diff > 0).mean() < 0.01


def test_transform_batch_order_and_tolerance(batch):
    wb, gc, he = transform_batch(torch.from_numpy(batch))
    jwb, jgc, jhe = jax_transform(batch)
    for t in (wb, gc, he):
        assert t.dtype == torch.float32 and tuple(t.shape) == batch.shape
    np.testing.assert_array_equal(wb.numpy(), jwb)
    np.testing.assert_array_equal(gc.numpy(), jgc)
    diff = np.abs(he.numpy() - jhe)
    assert diff.max() <= 1.0 and (diff > 0).mean() < 0.01


def test_transform_np_host_path_bitexact(batch):
    for im in batch:
        for a, b in zip(transform_np(im), jax_transform_np(im)):
            assert a.dtype == np.uint8
            np.testing.assert_array_equal(a, b)
