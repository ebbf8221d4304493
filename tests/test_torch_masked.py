"""The port's masked transforms (waternet_tpu_torch.ops.masked), on the CPU:
native-first WB/GC/CLAHE on bucket canvases, the device-preprocess
serving path.

Bounds:

* Against the port's own native device transforms
  (``ops/transform.py::transform_batch``), on each image's native region:
  WB, GC and ``histeq`` (CLAHE included) bit for bit. The CLAHE blend is
  the same eager ops in the same order as the native path's plain blend,
  which the card's ``clahe_lut_blend`` kernel equals bit for bit.
* Against the JAX package's ``ops/masked.py`` run op by op
  (``jax.disable_jit()``), over the whole canvas: WB, GC and the CLAHE L
  plane bit for bit; ``histeq``'s float LAB inverse within one level on a
  few pixels (ROADMAP Queue C: XLA's CPU code contracts the inverse's
  multiply-adds differently).
* ``luts_from_hist`` with per-tile clip and scale tensors equals the
  scalar form tile by tile.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from waternet_tpu.ops.masked import clahe_masked as jax_clahe_masked
from waternet_tpu.ops.masked import transform_masked as jax_transform_masked
from waternet_tpu.serving.bucketing import pad_to_bucket as jax_pad_to_bucket
from waternet_tpu_torch.ops import kernels
from waternet_tpu_torch.ops.color import rgb_to_lab_u8
from waternet_tpu_torch.ops.masked import (
    clahe_masked,
    transform_masked,
    transform_masked_batch,
)
from waternet_tpu_torch.ops.transform import transform_batch
from waternet_tpu_torch.serving.bucketing import pad_to_bucket

#: (native shapes of one batch, its bucket): the JAX package's two cases
#: (a width-only pad; a pad on both axes, neither divisible by the tile
#: grid) and one whose images divide it (48x64) beside one that does not.
CASES = [
    (((40, 52), (40, 64)), (40, 64)),
    (((33, 41), (64, 80)), (64, 80)),
    (((48, 64), (41, 57)), (64, 80)),
]


def photo(h, w, seed):
    """Smooth fields plus noise, so WB and CLAHE see photo-like histograms."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack(
        [60 + 40 * np.sin(xx / 7 + c) + 30 * np.cos(yy / 5 + 2 * c) + 45 * c for c in range(3)],
        axis=-1,
    )
    return np.clip(base + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)


def batch(shapes, bucket, seed=0):
    images = [photo(h, w, seed + i) for i, (h, w) in enumerate(shapes)]
    canvas = np.stack([pad_to_bucket(im, *bucket) for im in images])
    return images, canvas, np.asarray(shapes, np.int32)


@pytest.mark.parametrize("shapes,bucket", CASES, ids=lambda c: str(c).replace(" ", ""))
def test_masked_native_region_equals_port_transforms(shapes, bucket):
    images, canvas, hw = batch(shapes, bucket)
    wb, gc, he = transform_masked_batch(torch.from_numpy(canvas), torch.from_numpy(hw))
    for i, im in enumerate(images):
        h, w = im.shape[:2]
        nwb, ngc, nhe = transform_batch(torch.from_numpy(im[None]))
        assert torch.equal(wb[i, :h, :w], nwb[0])
        assert torch.equal(gc[i, :h, :w], ngc[0])
        assert torch.equal(he[i, :h, :w], nhe[0])


@pytest.mark.parametrize("shapes,bucket", CASES, ids=lambda c: str(c).replace(" ", ""))
def test_masked_matches_jax_op_by_op_over_the_canvas(shapes, bucket):
    images, canvas, hw = batch(shapes, bucket, seed=7)
    wb, gc, he = transform_masked_batch(torch.from_numpy(canvas), torch.from_numpy(hw))
    l_plane = rgb_to_lab_u8(torch.from_numpy(canvas))[..., 0]
    el = clahe_masked(l_plane, torch.from_numpy(hw[:, 0]), torch.from_numpy(hw[:, 1]))
    for i, (h, w) in enumerate(shapes):
        assert np.array_equal(canvas[i], jax_pad_to_bucket(images[i], *bucket))
        with jax.disable_jit():
            jwb, jgc, jhe = (
                np.asarray(a)
                for a in jax_transform_masked(jnp.asarray(canvas[i]), jnp.int32(h), jnp.int32(w))
            )
            jel = np.asarray(
                jax_clahe_masked(jnp.asarray(l_plane[i].numpy()), jnp.int32(h), jnp.int32(w))
            )
        np.testing.assert_array_equal(wb[i].numpy(), jwb)
        np.testing.assert_array_equal(gc[i].numpy(), jgc)
        np.testing.assert_array_equal(el[i].numpy(), jel)
        diff = np.abs(he[i].numpy() - jhe)
        assert diff.max() <= 1
        assert (diff > 0).mean() < 0.01


def test_transform_masked_one_canvas_equals_the_batch():
    images, canvas, hw = batch(((33, 41), (64, 80)), (64, 80), seed=3)
    got = transform_masked(torch.from_numpy(canvas[0]), 33, 41)
    want = transform_masked_batch(torch.from_numpy(canvas), torch.from_numpy(hw))
    for g, w in zip(got, want):
        assert torch.equal(g, w[0])


def test_masked_statistics_ignore_the_pad_content():
    """Whatever the canvas holds beyond the native region, the native
    region's output is the same: the statistics never read the pad."""
    images, canvas, hw = batch(((33, 41), (40, 52)), (64, 80), seed=5)
    wild = canvas.copy()
    wild[0, 33:, :] = 255
    wild[0, :, 41:] = 0
    wild[1, 40:, :] = 17
    a = transform_masked_batch(torch.from_numpy(canvas), torch.from_numpy(hw))
    b = transform_masked_batch(torch.from_numpy(wild), torch.from_numpy(hw))
    for x, y in zip(a, b):
        for i, (h, w) in enumerate(hw):
            assert torch.equal(x[i, :h, :w], y[i, :h, :w])


def test_luts_from_hist_per_tile_clip_and_scale_equals_scalar_form():
    rng = np.random.default_rng(11)
    hist = torch.from_numpy(rng.integers(0, 40, (6, 256)))
    clips = [1, 3, 7, 2, 40, 5]
    scales = [np.float32(255.0) / np.float32(a) for a in (17, 64, 300, 100, 2000, 9)]
    got = kernels.luts_from_hist(
        hist, torch.tensor(clips), torch.tensor(np.asarray(scales, np.float32))
    )
    for t in range(6):
        want = kernels.luts_from_hist(hist[t : t + 1], clips[t], scales[t])
        assert torch.equal(got[t : t + 1], want)
