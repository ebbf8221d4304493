"""The kernels' plain versions (waternet_tpu_torch.ops.kernels) against
the JAX package's Pallas kernels run in interpret mode, as
tests/test_pallas.py runs them; the wrappers' routing and launch counters;
and the kernel sources and build settings. Every CLAHE comparison is bit
for bit: both sides are integer pipelines or exact lookups. (The dct8
kernel's plain version is held against JAX in tests/test_torch_codec.py.)

The CUDA kernels themselves run only on the card, where ``chip_smoke.py``
holds each against its plain version.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from waternet_tpu.ops import pallas_kernels as pk
from waternet_tpu.ops.clahe import _cell_tile_indices
from waternet_tpu_torch.ops import _build, kernels


@pytest.mark.parametrize("t,area", [(4, 196), (3, 77), (9, 121), (5, 2048), (1, 5000)])
def test_plain_tile_lut_matches_pallas_interpret(t, area):
    """(T, A) tiles as T images of one 1 x A tile each."""
    rng = np.random.default_rng(t * 10_000 + area)
    tiles = rng.integers(0, 256, size=(t, area)).astype(np.uint8)
    clip = max(int(0.1 * area / 256.0), 1)
    scale = np.float32(255.0) / np.float32(area)
    want = np.asarray(pk.tile_lut(jnp.asarray(tiles), clip, scale, interpret=True))
    got = kernels.tile_lut(torch.from_numpy(tiles[:, None, :]), (1, 1), clip, scale)
    assert got.shape == (t, 1, 1, 256) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.reshape(t, 256).numpy(), want)


def test_plain_tile_lut_tile_layout_matches_pallas_interpret():
    """A real 8x8 grid over (2, 64, 96) planes: tile (i, j) of image n is
    row n * 64 + i * 8 + j of the JAX kernel's (T, A) input."""
    rng = np.random.default_rng(1)
    planes = rng.integers(0, 256, size=(2, 64, 96)).astype(np.uint8)
    tiles = planes.reshape(2, 8, 8, 8, 12).transpose(0, 1, 3, 2, 4).reshape(128, 96)
    clip, scale = 1, np.float32(255.0) / np.float32(96)
    want = np.asarray(pk.tile_lut(jnp.asarray(tiles), clip, scale, interpret=True))
    got = kernels.tile_lut_plain(torch.from_numpy(planes), (8, 8), clip, scale)
    np.testing.assert_array_equal(got.reshape(128, 256).numpy(), want)


@pytest.mark.parametrize(
    "hw,grid",
    [
        ((19, 23), (3, 4)),  # odd tiles both axes
        ((33, 17), (5, 3)),  # odd tiles, divisibility padding
        ((40, 56), (4, 7)),  # even-H cells, odd-W cells
        ((64, 64), (8, 8)),  # even half-tile cells
    ],
)
def test_plain_clahe_lut_planes_matches_pallas_interpret(hw, grid):
    rng = np.random.default_rng(hw[0] + hw[1])
    ty, tx = grid
    hp, wp = -(-hw[0] // ty) * ty, -(-hw[1] // tx) * tx
    th, tw = hp // ty, wp // tx
    v = rng.integers(0, 256, size=(hp, wp)).astype(np.uint8)
    luts = rng.integers(0, 256, size=(ty, tx, 256)).astype(np.float32)
    cell_h, cells_y = _cell_tile_indices(hp, th, ty)
    cell_w, cells_x = _cell_tile_indices(wp, tw, tx)
    want = pk.clahe_lut_planes(
        jnp.asarray(luts), jnp.asarray(v), cells_y, cells_x, cell_h, cell_w,
        interpret=True,
    )
    y1, y2 = kernels.tile_indices(hp, th, ty)
    x1, x2 = kernels.tile_indices(wp, tw, tx)
    # The per-pixel indices are the JAX cell indices expanded to pixels.
    for mine, cells, cell in ((y1, cells_y[0], cell_h), (y2, cells_y[1], cell_h),
                              (x1, cells_x[0], cell_w), (x2, cells_x[1], cell_w)):
        np.testing.assert_array_equal(mine, np.repeat(cells, cell))
    got = kernels.clahe_lut_planes(
        torch.from_numpy(luts[None]), torch.from_numpy(v[None]),
        *(torch.from_numpy(a) for a in (y1, y2, x1, x2)),
    )
    assert got.shape == (4, 1, hp, wp)
    for q in range(4):
        np.testing.assert_array_equal(got[q, 0].numpy(), np.asarray(want[q]))


def test_cpu_tensors_route_to_plain_and_leave_counters():
    kernels.reset_launches()
    planes = torch.zeros((1, 16, 16), dtype=torch.uint8)
    luts = kernels.tile_lut(planes, (8, 8), 1, np.float32(255.0) / np.float32(4))
    y1, y2 = (torch.from_numpy(a) for a in kernels.tile_indices(16, 2, 8))
    kernels.clahe_lut_planes(luts, planes, y1, y2, y1, y2)
    ya, xa = torch.zeros((13, 1)), torch.zeros((1, 11))
    blend = kernels.clahe_lut_blend(luts, planes, y1, y2, y1, y2, ya, xa, 13, 11)
    assert blend.shape == (1, 13, 11) and blend.dtype == torch.float32
    hist = kernels.tile_histogram(planes, (8, 8))
    assert hist.dtype == torch.int32 and hist.shape == (1, 8, 8, 256)
    out = kernels.dct8_dequant_idct(
        torch.zeros((3, 16), dtype=torch.int8), torch.ones(16), torch.ones((16, 64))
    )
    assert out.shape == (3, 64) and not out.any()
    u8 = kernels.dct8_decode_u8(
        torch.zeros((2, 2, 3, 3, 16), dtype=torch.int8), torch.ones(16), torch.ones((16, 64)),
        13, 21,
    )
    assert u8.dtype == torch.uint8 and u8.shape == (2, 13, 21, 3) and bool((u8 == 128).all())
    assert kernels.LAUNCHES == {
        "tile_lut": 0, "clahe_lut_planes": 0, "tile_histogram": 0, "dct8_dequant_idct": 0,
    }


@pytest.mark.parametrize("t,area", [(4, 196), (64, 196), (3, 5000)])
def test_plain_tile_histogram_matches_pallas_interpret(t, area):
    """The shapes of tests/test_pallas.py; (T, A) tiles as T images of one
    1 x A tile each."""
    rng = np.random.default_rng(t * 7 + area)
    tiles = rng.integers(0, 256, size=(t, area)).astype(np.uint8)
    want = np.asarray(pk.tile_histogram(jnp.asarray(tiles), interpret=True))
    got = kernels.tile_histogram(torch.from_numpy(tiles[:, None, :]), (1, 1))
    assert got.shape == (t, 1, 1, 256) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.reshape(t, 256).numpy(), want)


def test_plain_tile_histogram_tile_layout_matches_pallas_interpret():
    """An 8x8 grid over (2, 64, 96) planes: tile (i, j) of image n is row
    n * 64 + i * 8 + j of the JAX kernel's (T, A) input."""
    rng = np.random.default_rng(2)
    planes = rng.integers(0, 256, size=(2, 64, 96)).astype(np.uint8)
    tiles = planes.reshape(2, 8, 8, 8, 12).transpose(0, 1, 3, 2, 4).reshape(128, 96)
    want = np.asarray(pk.tile_histogram(jnp.asarray(tiles), interpret=True))
    got = kernels.tile_histogram_plain(torch.from_numpy(planes), (8, 8))
    np.testing.assert_array_equal(got.reshape(128, 256).numpy(), want)


@pytest.mark.parametrize("shape", [(2, 64, 96), (1, 40, 56), (3, 24, 24)])
def test_tile_lut_plain_is_luts_from_tile_histogram(shape):
    """tile_lut's plain version is the plain histogram then luts_from_hist,
    the identity chip_smoke.py checks between the two CUDA kernels."""
    rng = np.random.default_rng(sum(shape))
    planes = torch.from_numpy(rng.integers(0, 256, size=shape).astype(np.uint8))
    area = (shape[1] // 8) * (shape[2] // 8)
    clip, scale = max(int(0.1 * area / 256.0), 1), np.float32(255.0) / np.float32(area)
    hist = kernels.tile_histogram_plain(planes, (8, 8))
    assert int(hist.sum()) == planes.numel()
    want = kernels.luts_from_hist(hist.reshape(-1, 256), clip, scale).reshape(hist.shape)
    assert torch.equal(kernels.tile_lut_plain(planes, (8, 8), clip, scale), want)


def test_dct8_wrapper_refuses_other_devices():
    coef = torch.zeros((4, 16), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        kernels.dct8_dequant_idct(coef, torch.ones(16), torch.ones((16, 64)))


def test_other_devices_are_refused():
    planes = torch.zeros((1, 16, 16), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        kernels.tile_lut(planes, (8, 8), 1, 1.0)


def test_grid_must_divide_the_padded_plane():
    with pytest.raises(ValueError, match="not divisible"):
        kernels.tile_lut(torch.zeros((1, 15, 16), dtype=torch.uint8), (8, 8), 1, 1.0)


# (n, hp, wp) padded planes under the 8x8 grid -> (cluster, vector width):
# R1, the odd request, T1's and T2's planes, and 2x37x53 (padded 40x56).
_PLANS = {
    "R1": ((4, 1080, 1920), (1, 16)),
    "odd": ((1, 728, 1008), (4, 2)),
    "T1": ((8, 256, 256), (1, 16)),
    "T2": ((16, 112, 112), (1, 2)),
    "tiny": ((2, 40, 56), (1, 1)),
}


@pytest.mark.parametrize("tag", sorted(_PLANS))
def test_tile_plan_at_the_held_shapes(tag):
    (n, hp, wp), want = _PLANS[tag]
    plan = kernels.tile_plan(n, hp, wp, 8, 8, 1 << 20, 132)
    assert (plan.cluster, plan.vec) == want
    th, tw = hp // 8, wp // 8
    assert tw % plan.vec == 0 and wp % plan.vec == 0
    assert plan.cluster in (1, 2, 4, 8) and plan.grid == n * 64 * plan.cluster
    assert plan.grid % plan.cluster == 0 and plan.threads == 256
    # Tiles are split only while the grid has fewer CTAs than SMs, and
    # never below 2,048 pixels a CTA.
    if plan.cluster > 1:
        assert plan.grid // 2 < 132 and -(-th * tw // plan.cluster) >= 2048
    # A card with 8 SMs fills with whole tiles: no split; one with 1,000
    # splits the 1080p tiles too.
    assert kernels.tile_plan(n, hp, wp, 8, 8, 1 << 20, 8).cluster == 1
    if tag == "R1":
        assert kernels.tile_plan(n, hp, wp, 8, 8, 1 << 20, 1000).cluster == 4


@pytest.mark.parametrize("offset,vec", [(0, 16), (8, 8), (4, 4), (2, 2), (3, 1), (1, 1)])
def test_tile_plan_follows_the_planes_address(offset, vec):
    """A plane that starts off a 16-byte boundary takes the widest load its
    address allows; every tile's column offset stays a multiple of it."""
    plan = kernels.tile_plan(4, 1080, 1920, 8, 8, (1 << 20) + offset, 132)
    assert plan.vec == vec and ((1 << 20) + offset) % plan.vec == 0
    assert all((j * 240) % plan.vec == 0 for j in range(8))


@pytest.mark.parametrize(
    "shape,vec",
    [((16, 256, 256), 16), ((8, 256, 256), 16), ((3, 104, 136), 8), ((2, 100, 130), 2),
     ((2, 37, 53), 1)],
)
def test_dct8_decode_plan(shape, vec):
    b, h, w = shape
    nby, nbx = -(-h // 8), -(-w // 8)
    plan = kernels.dct8_decode_plan(b, nby, nbx, 3, w, 1 << 20, 132)
    assert plan.vec == vec and (w * 3) % plan.vec == 0
    assert plan.pitch % 128 == 16 and nbx * 24 <= plan.pitch < nbx * 24 + 144
    assert plan.ctas == min(b * nby, 132 * 2)
    assert kernels.dct8_decode_plan(b, nby, nbx, 3, w, (1 << 20) + 1, 132).vec == 1
    assert kernels.dct8_ctas(10_000, 132) == 264 and kernels.dct8_ctas(0, 132) == 1


def test_kernel_source_and_build_flags():
    assert [p.name for p in _build.SOURCES] == ["clahe.cu", "codec.cu"]
    src = "\n".join(p.read_text() for p in _build.SOURCES)
    for name in ("clahe_tile_lut_kernel", "clahe_lut_planes_kernel",
                 "clahe_tile_histogram_kernel", "dct8_dequant_idct_kernel",
                 "dct8_decode_u8_kernel", "waternet_clahe_tile_lut",
                 "waternet_clahe_lut_planes", "waternet_clahe_tile_histogram",
                 "waternet_dct8_dequant_idct", "waternet_dct8_decode_u8"):
        assert name in src
    clahe_src, codec_src = (p.read_text() for p in _build.SOURCES)
    # tile_lut and tile_histogram share their histogram phase, under one
    # cluster launch whose CTAs meet in distributed shared memory.
    assert clahe_src.count("tile_bin_count<V>(l, hp, wp, ty, tx)") == 2
    # Both interpolation kernels share one lookup phase; the blend rounds
    # each op once in the eager order (no FMA) and rounds half to even.
    for name in ("clahe_lut_blend_kernel", "waternet_clahe_lut_blend"):
        assert name in clahe_src
    assert clahe_src.count("band_lookup<V>(luts, l, strips, y1, y2, x1, x2, hp, wp, ty, tx,") == 2
    assert "__fsub_rn(1.0f, wy)" in clahe_src and "__fsub_rn(1.0f, wx[j])" in clahe_src
    assert "__fmul_rn" in clahe_src and "__fadd_rn" in clahe_src
    assert "fmaf" not in clahe_src and "rintf(b)" in clahe_src
    assert "cudaLaunchKernelEx" in clahe_src
    assert "cudaLaunchAttributeClusterDimension" in clahe_src
    assert "map_shared_rank" in clahe_src and "cluster.sync()" in clahe_src
    # Both dct8 epilogues share one product, which rounds each op as the
    # plain version does: no FMA.
    assert codec_src.count("dequant_idct_quad(") == 3
    assert "__fmul_rn" in codec_src and "__fadd_rn" in codec_src
    assert "fmaf" not in codec_src and "__fmaf" not in codec_src
    # The uint8 epilogue rounds half to even, as torch.round.
    assert "rintf(__fadd_rn(acc, 128.0f))" in codec_src
    assert "rintf" in src and "roundf" not in src
    assert _build.ARCH == "sm_90a"
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert not any("fast_math" in f for f in _build.NVCC_FLAGS)
    assert _build.BUILD_DIR.parts[-2:] == ("build", "kernels")


def _blend_np(p11, p12, p21, p22, ya, xa):
    """CLAHE's blend in numpy float32, one rounded op at a time, rounded
    half to even and clipped."""
    one = np.float32(1.0)
    top = p11 * (one - xa) + p12 * xa
    bot = p21 * (one - xa) + p22 * xa
    res = top * (one - ya) + bot * ya
    return np.clip(np.round(res), np.float32(0.0), np.float32(255.0))


def _weights(n_pix, tile):
    """frac(i * f32(1/tile) - 0.5), as cv2 (and ops/clahe.py)."""
    c = np.arange(n_pix, dtype=np.float32) * (np.float32(1.0) / np.float32(tile)) - np.float32(0.5)
    return c - np.floor(c)


@pytest.mark.parametrize(
    "hw,grid",
    [
        ((19, 23), (3, 4)),
        ((33, 17), (5, 3)),
        ((40, 56), (4, 7)),
        ((64, 64), (8, 8)),
    ],
)
def test_plain_clahe_lut_blend_matches_pallas_interpret_and_numpy_blend(hw, grid):
    """The fused kernel's plain version against the JAX Pallas lookup (in
    interpret mode) followed by the blend in numpy float32 op by op, on
    random fractional f32 LUTs, cropped to ``hw``."""
    rng = np.random.default_rng(7 * hw[0] + hw[1])
    (h, w), (ty, tx) = hw, grid
    hp, wp = -(-h // ty) * ty, -(-w // tx) * tx
    th, tw = hp // ty, wp // tx
    v = rng.integers(0, 256, size=(hp, wp)).astype(np.uint8)
    luts = (rng.random((ty, tx, 256), dtype=np.float32) * np.float32(255.0)).astype(np.float32)
    cell_h, cells_y = _cell_tile_indices(hp, th, ty)
    cell_w, cells_x = _cell_tile_indices(wp, tw, tx)
    planes = pk.clahe_lut_planes(
        jnp.asarray(luts), jnp.asarray(v), cells_y, cells_x, cell_h, cell_w, interpret=True,
    )
    ya, xa = _weights(h, th)[:, None], _weights(w, tw)[None, :]
    want = _blend_np(*(np.asarray(p)[:h, :w] for p in planes), ya, xa)
    idx = [torch.from_numpy(a) for a in (*kernels.tile_indices(hp, th, ty),
                                         *kernels.tile_indices(wp, tw, tx))]
    got = kernels.clahe_lut_blend_plain(
        torch.from_numpy(luts[None]), torch.from_numpy(v[None]), *idx,
        torch.from_numpy(ya), torch.from_numpy(xa), h, w,
    )
    assert got.shape == (1, h, w) and got.dtype == torch.float32
    np.testing.assert_array_equal(got[0].numpy(), want)
    # The wrapper routes the CPU tensors to the plain version.
    assert torch.equal(kernels.clahe_lut_blend(
        torch.from_numpy(luts[None]), torch.from_numpy(v[None]), *idx,
        torch.from_numpy(ya), torch.from_numpy(xa), h, w,
    ), got)


def test_plain_clahe_lut_blend_matches_pallas_on_a_cropped_odd_shape():
    """Two 45x71 planes padded by ``clahe_inputs`` (to 48x72): the geometry
    the wrapper gets on the main path, against the JAX lookup per image and
    the numpy blend, cropped."""
    from waternet_tpu_torch.ops.clahe import clahe_inputs

    rng = np.random.default_rng(4571)
    lum = torch.from_numpy(rng.integers(0, 256, size=(2, 45, 71)).astype(np.uint8))
    l_pad, _, _, g = clahe_inputs(lum)
    hp, wp = l_pad.shape[1:]
    assert (hp, wp) == (48, 72)
    th, tw = g["tile"]
    luts = (rng.random((2, 8, 8, 256), dtype=np.float32) * np.float32(255.0)).astype(np.float32)
    cell_h, cells_y = _cell_tile_indices(hp, th, 8)
    cell_w, cells_x = _cell_tile_indices(wp, tw, 8)
    got = kernels.clahe_lut_blend_plain(torch.from_numpy(luts), l_pad, *g["y"], *g["x"],
                                        g["ya"], g["xa"], 45, 71)
    for i in range(2):
        planes = pk.clahe_lut_planes(jnp.asarray(luts[i]), jnp.asarray(l_pad[i].numpy()),
                                     cells_y, cells_x, cell_h, cell_w, interpret=True)
        want = _blend_np(*(np.asarray(p)[:45, :71] for p in planes),
                         g["ya"].numpy(), g["xa"].numpy())
        np.testing.assert_array_equal(got[i].numpy(), want)


def test_blend_one_minus_weight_is_the_single_rounded_f32_difference():
    """torch's ``1.0 - xa`` on a float32 tensor is numpy's float32
    ``1 - xa`` (what the kernel's ``__fsub_rn(1.0f, xa)`` computes): one
    rounding of the exact difference, at every weight the geometry makes
    and at the weights nearest 0 and 1."""
    ws = [_weights(n, t) for n, t in ((1080, 135), (723, 91), (256, 32), (112, 14), (53, 7))]
    edge = np.array([0.0, np.nextafter(np.float32(0), np.float32(1)), np.float32(0.5),
                     np.nextafter(np.float32(1), np.float32(0))], dtype=np.float32)
    xa = np.concatenate([*ws, edge]).astype(np.float32)
    got = (1.0 - torch.from_numpy(xa)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.float32(1.0) - xa)
    np.testing.assert_array_equal(got, (1.0 - xa.astype(np.float64)).astype(np.float32))


# (n, h, w, ty, tx): R1, the odd request, T1's and T2's planes, 2x37x53,
# and 5x7 frames under the 8x8 grid (padded 8x8: 1-pixel tiles, every row
# its own band).
_BLEND_SHAPES = {
    "R1": (4, 1080, 1920, 8, 8),
    "odd": (1, 723, 1001, 8, 8),
    "T1": (8, 256, 256, 8, 8),
    "T2": (16, 112, 112, 8, 8),
    "tiny": (2, 37, 53, 8, 8),
    "th1": (2, 5, 7, 8, 8),
}


def _padded(h, w, ty, tx):
    if h % ty == 0 and w % tx == 0:
        return h, w
    return h + ty - h % ty, w + tx - w % tx


@pytest.mark.parametrize("kind", ["blend", "planes"])
@pytest.mark.parametrize("tag", sorted(_BLEND_SHAPES))
def test_lut_blend_plan_invariants(tag, kind):
    n, h, w, ty, tx = _BLEND_SHAPES[tag]
    hp, wp = _padded(h, w, ty, tx)
    rows, cols = (h, w) if kind == "blend" else (hp, wp)
    y1, y2 = kernels.tile_indices(hp, hp // ty, ty)
    l_ptr, out_ptr = 1 << 20, 1 << 21
    plan = kernels.lut_blend_plan(n, rows, cols, wp, tx, y1, y2, l_ptr, out_ptr, 132)
    starts = np.asarray(plan.strips)
    # The rows are covered exactly once, in order.
    assert starts[0] == 0 and starts[-1] == rows and (np.diff(starts) > 0).all()
    assert plan.grid == (len(starts) - 1, n) and plan.threads == 256
    # Every strip's rows lie in one band of constant (y1, y2): the two tile
    # rows the CTA stages are all it reads.
    for lo, hi in zip(starts[:-1], starts[1:]):
        assert (y1[lo:hi] == y1[lo]).all() and (y2[lo:hi] == y2[lo]).all()
    # Two tile rows of LUTs: 16 KB at the 8x8 grid.
    assert plan.smem == 2 * tx * 256 * 4 == 16384
    # The vector width divides the row pitches and both addresses.
    assert cols % plan.vec == 0 and wp % plan.vec == 0
    assert plan.vec in (4, 2, 1) and l_ptr % plan.vec == 0 and out_ptr % (4 * plan.vec) == 0
    # Strips are no longer than the plan's length and at most one row apart
    # within a band.
    per = max(-(-1024 // cols), n * rows // (16 * 132), 1)
    assert np.diff(starts).max() <= per
    band = [(y1[r], y2[r]) for r in starts[:-1]]
    for b in set(band):
        sizes = [hi - lo for lo, hi, bb in zip(starts[:-1], starts[1:], band) if bb == b]
        assert max(sizes) - min(sizes) <= 1
    if tag == "th1":
        assert len(starts) - 1 == rows  # every row its own band
    if tag == "T1":
        assert plan.vec == 4 and plan.grid[0] * n == 512  # 4-row strips, ~4 CTAs per SM
    if tag == "odd" and kind == "blend":
        assert plan.vec == 1  # 1001-wide rows: scalar stores
    if tag == "R1":
        assert plan.vec == 4


@pytest.mark.parametrize("l_off,out_off,vec", [(0, 0, 4), (4, 16, 4), (2, 0, 2), (0, 8, 2),
                                               (4, 4, 1), (1, 0, 1)])
def test_lut_blend_plan_follows_the_addresses(l_off, out_off, vec):
    """At R1 the width follows the plane's address (V-byte loads) and the
    output's (a float4 store for V = 4, float2 for V = 2)."""
    y1, y2 = kernels.tile_indices(1080, 135, 8)
    plan = kernels.lut_blend_plan(4, 1080, 1920, 1920, 8, y1, y2, (1 << 20) + l_off,
                                  (1 << 20) + out_off, 132)
    assert plan.vec == vec


def test_band_strips_cuts_bands_evenly():
    y1 = np.array([0] * 5 + [0] * 9 + [1] * 3, dtype=np.int32)
    y2 = np.array([0] * 5 + [1] * 9 + [1] * 3, dtype=np.int32)
    assert kernels.band_strips(y1, y2, 4) == (0, 2, 5, 8, 11, 14, 17)
    assert kernels.band_strips(y1, y2, 100) == (0, 5, 14, 17)
