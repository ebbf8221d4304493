"""Wrappers of the port's CUDA kernels (``csrc/clahe.cu``,
``csrc/codec.cu``), their plain PyTorch versions, and the launch counters.

A wrapper given a CPU tensor runs the plain version. Given a CUDA tensor
it launches the kernel, after checking device, dtype, shape and
contiguity, and raises on anything else; there is no fallback from the
kernel to the plain version. ``LAUNCHES[name]`` counts kernel launches,
and only those.

==================  ===============================================  ==========
wrapper             replaces (TPU kernel)                            bound by
==================  ===============================================  ==========
tile_lut            pallas_kernels.py:133 ``_lut_kernel`` (:201)     bytes
tile_histogram      pallas_kernels.py:71 ``_hist_kernel`` (:106)     bytes
clahe_lut_planes    pallas_kernels.py:229 ``_interp_kernel`` (:269)  bytes
clahe_lut_blend     the same, with CLAHE's blend, rounding and crop  bytes
dct8_dequant_idct   pallas_kernels.py:330 ``_dct8_kernel`` (:366)    bytes
dct8_decode_u8      the same, with the decode's uint8 epilogue       operations
==================  ===============================================  ==========

``clahe_lut_blend`` and ``dct8_decode_u8`` are TPU kernels with another
epilogue, so their launches count under ``LAUNCHES["clahe_lut_planes"]``
and ``LAUNCHES["dct8_dequant_idct"]``. The launch plans (:func:`tile_plan`,
:func:`lut_blend_plan`, :func:`dct8_ctas`, :func:`dct8_decode_plan`) are
pure functions of the shapes, the card's SM count and the data's address.

The plain versions are the reference arithmetic (bincount, cumsum,
advanced indexing, one rounded op at a time). The tests hold them against
the JAX kernels; on the card, ``chip_smoke.py`` holds each kernel against
them. Nothing on the main path calls them on a CUDA tensor.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

LAUNCHES = {"tile_lut": 0, "clahe_lut_planes": 0, "tile_histogram": 0, "dct8_dequant_idct": 0}

_BINS = 256
_MAX_SMEM = 232_448  # dynamic shared memory a Hopper CTA may opt into
_WIDTHS = (16, 8, 4, 2, 1)  # vector widths of the kernels' loads and stores, bytes
_CLUSTERS = (1, 2, 4, 8)  # CTAs per tile cluster (8 is the portable maximum)
_CTA_MIN_PIXELS = 2048  # pixels a CTA of a tile cluster counts, at least
_TILE_CTAS_PER_SM = 1  # a tile grid with fewer CTAs than this per SM is split
_LUT_THREADS = 256  # one thread per bin
_STRIP_THREADS = 256
_STRIP_WIDTHS = (4, 2, 1)  # pixels a thread takes a step in the interpolation kernels
_STRIP_MIN_PIXELS = 1024  # pixels an interpolation CTA takes, at least
_STRIP_CTAS_PER_SM = 16  # interpolation CTAs per SM, at most, from shorter strips
_DCT_THREADS = 256
_DCT_CTAS_PER_SM = 2  # as many as fit: M in registers, ~120 a thread
_DCT_TABLE_SMEM = 16 * 64 * 4 + 16 * 4  # M and quant, staged by every dct8 CTA


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _route(t: torch.Tensor) -> bool:
    """True for the kernel (CUDA tensor), False for the plain version
    (CPU tensor); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"the port's kernels take CPU or CUDA tensors, got {t.device}")


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _grid(l_pad, tile_grid):
    if l_pad.ndim != 3:
        raise ValueError(f"l_pad: expected (N, hp, wp), got {tuple(l_pad.shape)}")
    n, hp, wp = l_pad.shape
    ty, tx = tile_grid
    if hp % ty or wp % tx:
        raise ValueError(
            f"padded plane {hp}x{wp} is not divisible by the tile grid {ty}x{tx}"
        )
    return n, hp, wp, ty, tx


def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def tile_indices(n_pix: int, tile: int, n_tiles: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-row (or per-column) indices ``(lo, hi)`` of the two tiles a
    pixel interpolates between: ``floor(i * f32(1/tile) - 0.5)`` in numpy
    float32, OpenCV's reciprocal multiply (waternet_tpu/ops/clahe.py:
    328-340), clamped to the grid. int32, values in ``[0, n_tiles)``."""
    inv = np.float32(1.0) / np.float32(tile)
    fl = np.floor(np.arange(n_pix, dtype=np.float32) * inv - np.float32(0.5))
    fl = fl.astype(np.int64)
    hi = np.minimum(fl + 1, n_tiles - 1)
    lo = np.maximum(fl, 0)
    return lo.astype(np.int32), hi.astype(np.int32)


# ---------------------------------------------------------------------------
# tile_lut: per-tile histogram -> clip/redistribute -> CDF -> LUT
# ---------------------------------------------------------------------------


class TilePlan(NamedTuple):
    """Launch plan of the tile kernels: ``cluster`` CTAs of ``threads``
    share each tile, each reading ``vec`` bytes a load; ``grid`` CTAs in
    all."""

    cluster: int
    vec: int
    threads: int
    grid: int


def tile_plan(n: int, hp: int, wp: int, ty: int, tx: int, data_ptr: int, sms: int) -> TilePlan:
    """The plan of :func:`tile_lut` and :func:`tile_histogram` over (n, hp,
    wp) planes at address ``data_ptr`` under a (ty, tx) grid, on a card
    with ``sms`` SMs.

    The vector width is the widest of 16, 8, 4, 2, 1 bytes that divides the
    tile width, the row pitch and the address, so every load is aligned.
    The cluster size K doubles from 1 (up to 8) while the grid has fewer
    CTAs than the card has SMs and each CTA would still count
    ``_CTA_MIN_PIXELS`` or more. A split tile pays a cluster barrier and
    its rank 0 waits for the slowest peer, so tiles are split only to fill
    the card: on the H100, K = 4 at 1 x 723x1001 (64 tiles), K = 1 at
    4 x 1080x1920 (256 tiles) and at the training planes
    (``chip_smoke.py`` times every K at the first two)."""
    th, tw = hp // ty, wp // tx
    vec = next(v for v in _WIDTHS if tw % v == 0 and wp % v == 0 and data_ptr % v == 0)
    tiles, area = n * ty * tx, th * tw
    cluster = 1
    for k in _CLUSTERS[1:]:
        if tiles * cluster >= _TILE_CTAS_PER_SM * sms or -(-area // k) < _CTA_MIN_PIXELS:
            break
        cluster = k
    return TilePlan(cluster, vec, _LUT_THREADS, tiles * cluster)


def luts_from_hist(hist: torch.Tensor, clip, scale) -> torch.Tensor:
    """(T, 256) integer histograms -> (T, 256) float32 LUTs: OpenCV's integer
    clip and excess redistribution, then ``clip(rint(cdf * scale), 0, 255)``
    with the single-rounded float32 ``scale`` (clahe.py:275-288).

    ``clip`` is an int or a (T,) integer tensor and ``scale`` a float32
    value or a (T,) float32 tensor, one per histogram (the masked CLAHE's
    per-image tile geometry); either way each LUT's arithmetic is the same."""
    if isinstance(clip, torch.Tensor):
        clip = clip[:, None].to(hist.dtype)
    excess = torch.clamp_min(hist - clip, 0).sum(dim=-1)  # (T,)
    hist = torch.clamp_max(hist, clip) + (excess // _BINS)[:, None]
    residual = excess % _BINS
    step = torch.clamp_min(_BINS // torch.clamp_min(residual, 1), 1)
    bins = torch.arange(_BINS, device=hist.device)
    inc = (
        (residual[:, None] > 0)
        & (bins[None, :] % step[:, None] == 0)
        & (bins[None, :] // step[:, None] < residual[:, None])
    )
    cdf = torch.cumsum(hist + inc.to(hist.dtype), dim=-1).to(torch.float32)
    # A float32 value: the product rounds once, in float32.
    scale = scale[:, None] if isinstance(scale, torch.Tensor) else float(np.float32(scale))
    return torch.clamp(torch.round(cdf * scale), 0.0, 255.0)


def tile_histogram_plain(l_pad: torch.Tensor, tile_grid) -> torch.Tensor:
    """Plain version of :func:`tile_histogram`: one bincount."""
    n, hp, wp, ty, tx = _grid(l_pad, tile_grid)
    th, tw = hp // ty, wp // tx
    tiles = (
        l_pad.reshape(n, ty, th, tx, tw).permute(0, 1, 3, 2, 4).reshape(-1, th * tw)
    )
    n_tiles = tiles.shape[0]
    tile_ids = torch.arange(n_tiles, device=l_pad.device)[:, None] * _BINS
    # jaxlint: disable-next=R003 the plain version: on the card the wrapper launches the kernel
    hist = torch.bincount(
        (tiles.long() + tile_ids).reshape(-1), minlength=n_tiles * _BINS
    )
    return hist.to(torch.int32).reshape(n, ty, tx, _BINS)


def tile_histogram(l_pad: torch.Tensor, tile_grid) -> torch.Tensor:
    """(N, hp, wp) uint8 padded planes -> (N, ty, tx, 256) int32 per-tile
    histograms. CUDA: the histogram phase of :func:`tile_lut`, under the
    same :func:`tile_plan` (csrc/clahe.cu)."""
    if not _route(l_pad):
        return tile_histogram_plain(l_pad, tile_grid)
    n, hp, wp, ty, tx = _grid(l_pad, tile_grid)
    _check("l_pad", l_pad, torch.uint8, (n, hp, wp), l_pad.device)
    from waternet_tpu_torch.ops import _build

    lib = _build.load()
    out = torch.empty((n, ty, tx, _BINS), dtype=torch.int32, device=l_pad.device)
    plan = tile_plan(n, hp, wp, ty, tx, l_pad.data_ptr(), _sms(l_pad.device))
    with torch.cuda.device(l_pad.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.waternet_clahe_tile_histogram(
            l_pad.data_ptr(), out.data_ptr(), n, hp, wp, ty, tx, plan.cluster, plan.vec,
            stream,
        )
    if err:
        raise RuntimeError(f"clahe_tile_histogram_kernel launch failed: cudaError {err}")
    LAUNCHES["tile_histogram"] += 1
    return out


def tile_lut_plain(l_pad: torch.Tensor, tile_grid, clip: int, scale) -> torch.Tensor:
    """Plain version of :func:`tile_lut`: the plain histogram, then
    :func:`luts_from_hist`."""
    hist = tile_histogram_plain(l_pad, tile_grid)
    return luts_from_hist(hist.reshape(-1, _BINS), clip, scale).reshape(hist.shape)


def tile_lut(l_pad: torch.Tensor, tile_grid, clip: int, scale, plan: TilePlan | None = None
             ) -> torch.Tensor:
    """(N, hp, wp) uint8 padded L planes -> (N, ty, tx, 256) float32 CLAHE
    LUTs. ``clip`` is the integer clip limit, ``scale`` the float32
    ``255 / tile_area``. CUDA: one cluster of CTAs per tile, as ``plan``
    (default :func:`tile_plan`) says (csrc/clahe.cu); the LUTs are the same
    bits under every plan the kernel accepts."""
    if not _route(l_pad):
        return tile_lut_plain(l_pad, tile_grid, clip, scale)
    n, hp, wp, ty, tx = _grid(l_pad, tile_grid)
    _check("l_pad", l_pad, torch.uint8, (n, hp, wp), l_pad.device)
    from waternet_tpu_torch.ops import _build

    lib = _build.load()
    out = torch.empty((n, ty, tx, _BINS), dtype=torch.float32, device=l_pad.device)
    plan = plan or tile_plan(n, hp, wp, ty, tx, l_pad.data_ptr(), _sms(l_pad.device))
    with torch.cuda.device(l_pad.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.waternet_clahe_tile_lut(
            l_pad.data_ptr(), out.data_ptr(), n, hp, wp, ty, tx, int(clip),
            float(np.float32(scale)), plan.cluster, plan.vec, stream,
        )
    if err:
        raise RuntimeError(f"clahe_tile_lut_kernel launch failed: cudaError {err}")
    LAUNCHES["tile_lut"] += 1
    return out


# ---------------------------------------------------------------------------
# clahe_lut_planes: the four quadrant LUT lookups per pixel
# ---------------------------------------------------------------------------


class LutBlendPlan(NamedTuple):
    """Launch plan of :func:`clahe_lut_planes` and :func:`clahe_lut_blend`:
    one CTA of ``threads`` per (strip, image), ``grid`` = (strips, images);
    strip i is rows ``strips[i]`` to ``strips[i + 1]``, all in one band of
    constant row tile indices; each thread takes ``vec`` pixels a step;
    ``smem`` bytes of LUTs are staged per CTA."""

    strips: tuple
    vec: int
    threads: int
    grid: tuple
    smem: int


def band_strips(y1: np.ndarray, y2: np.ndarray, rows_per_strip: int) -> tuple:
    """Row starts (and the end) of strips of at most ``rows_per_strip``
    rows that cover ``range(len(y1))`` in order, each inside one band of
    constant ``(y1, y2)``; a band is cut into near-equal strips."""
    rows = len(y1)
    change = np.flatnonzero((np.diff(y1) != 0) | (np.diff(y2) != 0)) + 1
    edges = [0, *change.tolist(), rows]
    starts = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        k = -(-(hi - lo) // rows_per_strip)
        starts.extend(lo + (hi - lo) * i // k for i in range(k))
    return (*starts, rows)


def lut_blend_plan(n: int, rows: int, cols: int, wp: int, tx: int, y1, y2, l_ptr: int,
                   out_ptr: int, sms: int) -> LutBlendPlan:
    """The plan of the interpolation kernels over ``rows`` x ``cols`` pixels
    of (n, hp, wp) padded planes (the blend: the kept h x w; the planes:
    all of hp x wp), with row tile indices ``y1``, ``y2`` (numpy, from
    :func:`tile_indices`), on a card with ``sms`` SMs.

    The vector width is the widest of 4, 2, 1 pixels that divides ``cols``
    (the output's row pitch), ``wp`` (the plane's) and the plane's address,
    with the output's address aligned to its float4 (float2) stores; a
    warp's steps are consecutive, so 4 pixels a thread already make its
    loads and stores whole lines. Strips hold at least
    ``_STRIP_MIN_PIXELS`` pixels, are short enough for
    ``_STRIP_CTAS_PER_SM`` CTAs per SM, and never cross a band, so a CTA
    stages only the two tile rows of LUTs it reads (16 KB at the 8x8
    grid): on the H100, 512 CTAs at T1's 8 x 256x256 (4-row strips),
    about 2,200 at 4 x 1080x1920 (2-row strips; the staging comes from L2,
    and more, shorter strips were faster there than 4 CTAs per SM)."""
    vec = next(
        v for v in _STRIP_WIDTHS
        if cols % v == 0 and wp % v == 0 and l_ptr % v == 0 and out_ptr % (4 * v) == 0
    )
    per_strip = max(-(-_STRIP_MIN_PIXELS // cols), n * rows // (_STRIP_CTAS_PER_SM * sms), 1)
    strips = band_strips(np.asarray(y1)[:rows], np.asarray(y2)[:rows], per_strip)
    return LutBlendPlan(strips, vec, _STRIP_THREADS, (len(strips) - 1, n), 2 * tx * _BINS * 4)


@functools.lru_cache(maxsize=64)
def _cached_plan(n, rows, cols, hp, wp, ty, tx, l_align, out_align, sms) -> LutBlendPlan:
    """:func:`lut_blend_plan` per shape, from the row tile indices CLAHE
    makes (:func:`tile_indices`), so the wrapper reads nothing back from
    the card. A row whose indices differ (another caller's) still gets
    the right values: the kernel reads its LUTs from global memory."""
    y1, y2 = tile_indices(hp, hp // ty, ty)
    return lut_blend_plan(n, rows, cols, wp, tx, y1, y2, l_align, out_align, sms)


@functools.lru_cache(maxsize=64)
def _strip_table(strips: tuple, device: torch.device) -> torch.Tensor:
    # jaxlint: disable-next=R003 strip table (lru_cache per plan): a blocking copy, safe on every stream
    return torch.tensor(strips, dtype=torch.int32, device=device)


def _check_interp(luts, l_pad, y1, y2, x1, x2):
    """Shapes and dtypes of the interpolation kernels' common inputs;
    returns (n, hp, wp, ty, tx)."""
    if l_pad.ndim != 3 or luts.ndim != 4:
        raise ValueError("expected luts (N, ty, tx, 256) and l_pad (N, hp, wp)")
    n, hp, wp = l_pad.shape
    ty, tx = luts.shape[1:3]
    dev = l_pad.device
    _check("luts", luts, torch.float32, (n, ty, tx, _BINS), dev)
    _check("l_pad", l_pad, torch.uint8, (n, hp, wp), dev)
    for name, t, size in (("y1", y1, hp), ("y2", y2, hp), ("x1", x1, wp), ("x2", x2, wp)):
        _check(name, t, torch.int32, (size,), dev)
    if hp % ty or wp % tx:
        raise ValueError(f"padded plane {hp}x{wp} is not divisible by the tile grid {ty}x{tx}")
    if 2 * tx * _BINS * 4 > _MAX_SMEM:
        raise ValueError(f"two rows of {tx} tile LUTs exceed {_MAX_SMEM} B of shared memory")
    for name, t in (("luts", luts), ("x1", x1), ("x2", x2)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (read as 16-byte vectors)")
    return n, hp, wp, ty, tx


def _launch_interp(fn_name, luts, l_pad, out, rows, cols, rest) -> None:
    """Plan, then launch the C function ``fn_name`` (``waternet_<kernel>``)
    over ``rows`` x ``cols`` pixels, with the arguments ``rest`` after the
    strip table; counts under ``LAUNCHES["clahe_lut_planes"]``."""
    from waternet_tpu_torch.ops import _build

    n, hp, wp = l_pad.shape
    ty, tx = luts.shape[1:3]
    dev = l_pad.device
    plan = _cached_plan(n, rows, cols, hp, wp, ty, tx, l_pad.data_ptr() % 16,
                        out.data_ptr() % 16, _sms(dev))
    strips = _strip_table(plan.strips, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_build.load(), fn_name)(
            luts.data_ptr(), l_pad.data_ptr(), strips.data_ptr(), plan.grid[0], *rest,
            plan.vec, stream,
        )
    if err:
        raise RuntimeError(f"{fn_name.removeprefix('waternet_')}_kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES["clahe_lut_planes"] += 1


def clahe_lut_planes_plain(luts, l_pad, y1, y2, x1, x2) -> torch.Tensor:
    """Plain version of :func:`clahe_lut_planes`: advanced indexing."""
    n = l_pad.shape[0]
    img = torch.arange(n, device=l_pad.device)[:, None, None]
    v = l_pad.long()
    rows = [y[None, :, None].long() for y in (y1, y2)]
    cols = [x[None, None, :].long() for x in (x1, x2)]
    return torch.stack(
        [luts[img, r, c, v] for r in rows for c in cols]
    )  # quadrants 11, 12, 21, 22


def clahe_lut_planes(luts, l_pad, y1, y2, x1, x2) -> torch.Tensor:
    """Four-quadrant CLAHE LUT lookup over the padded plane.

    Args:
        luts: (N, ty, tx, 256) float32 per-tile LUTs.
        l_pad: (N, hp, wp) uint8 padded L planes.
        y1, y2: (hp,) int32 tile rows per pixel row; x1, x2: (wp,) int32
            tile columns per pixel column, from :func:`tile_indices` (values
            in range by construction), on the device of ``l_pad``.
    Returns:
        (4, N, hp, wp) float32: quadrants 11, 12, 21, 22, exact LUT values.

    CUDA: one CTA per (strip, image) under :func:`lut_blend_plan`, staging
    the two tile rows of LUTs its band reads (csrc/clahe.cu).
    """
    if not _route(l_pad):
        return clahe_lut_planes_plain(luts, l_pad, y1, y2, x1, x2)
    n, hp, wp, ty, tx = _check_interp(luts, l_pad, y1, y2, x1, x2)
    out = torch.empty((4, n, hp, wp), dtype=torch.float32, device=l_pad.device)
    if out.numel():
        _launch_interp(
            "waternet_clahe_lut_planes", luts, l_pad, out, hp, wp,
            (y1.data_ptr(), y2.data_ptr(), x1.data_ptr(), x2.data_ptr(), out.data_ptr(),
             n, hp, wp, ty, tx),
        )
    return out


def blend_quadrants(p11, p12, p21, p22, ya, xa) -> torch.Tensor:
    """CLAHE's bilinear blend of the four lookups, one rounded eager op at a
    time, then rounded half to even and clamped to [0, 255]."""
    res = (p11 * (1.0 - xa) + p12 * xa) * (1.0 - ya) + (
        p21 * (1.0 - xa) + p22 * xa
    ) * ya
    return torch.clamp(torch.round(res), 0.0, 255.0)


def clahe_lut_blend_plain(luts, l_pad, y1, y2, x1, x2, ya, xa, h: int, w: int) -> torch.Tensor:
    """Plain version of :func:`clahe_lut_blend`: the plain lookup, cropped,
    then :func:`blend_quadrants`."""
    p11, p12, p21, p22 = clahe_lut_planes_plain(luts, l_pad, y1, y2, x1, x2)[..., :h, :w]
    return blend_quadrants(p11, p12, p21, p22, ya, xa)


def clahe_lut_blend(luts, l_pad, y1, y2, x1, x2, ya, xa, h: int, w: int) -> torch.Tensor:
    """CLAHE's interpolation: the four-quadrant lookup of
    :func:`clahe_lut_planes` and the bilinear blend of
    :func:`blend_quadrants`, cropped to the kept ``h x w``.

    Args: as :func:`clahe_lut_planes`, and ``ya`` (h, 1), ``xa`` (1, w)
    float32 blend weights (``frac(i * f32(1/tile) - 0.5)``, host-made).
    Returns (N, h, w) float32 holding exact uint8 values.

    CUDA: one launch, the lookup phase of :func:`clahe_lut_planes` with the
    blend fused, each op rounded once in the eager order, so the result is
    the plain version's bits (csrc/clahe.cu). It counts under
    ``LAUNCHES["clahe_lut_planes"]``: one TPU kernel, two epilogues."""
    if not _route(l_pad):
        return clahe_lut_blend_plain(luts, l_pad, y1, y2, x1, x2, ya, xa, h, w)
    n, hp, wp, ty, tx = _check_interp(luts, l_pad, y1, y2, x1, x2)
    if not (0 < h <= hp and 0 < w <= wp):
        raise ValueError(f"crop {h}x{w} outside the padded {hp}x{wp} plane")
    _check("ya", ya, torch.float32, (h, 1), l_pad.device)
    _check("xa", xa, torch.float32, (1, w), l_pad.device)
    if xa.data_ptr() % 16:
        raise ValueError("xa must be 16-byte aligned (read as 16-byte vectors)")
    out = torch.empty((n, h, w), dtype=torch.float32, device=l_pad.device)
    if out.numel():
        _launch_interp(
            "waternet_clahe_lut_blend", luts, l_pad, out, h, w,
            (y1.data_ptr(), y2.data_ptr(), x1.data_ptr(), x2.data_ptr(), ya.data_ptr(),
             xa.data_ptr(), out.data_ptr(), n, hp, wp, ty, tx, h, w),
        )
    return out


# ---------------------------------------------------------------------------
# dct8_dequant_idct: the dct8 device-cache decode's dequantize + inverse DCT
# ---------------------------------------------------------------------------


def dct8_ctas(work: int, sms: int) -> int:
    """CTAs of a dct8 launch over ``work`` items (groups of 16
    block-channels, or image block-rows): one per item up to
    ``_DCT_CTAS_PER_SM`` per SM; each CTA stages the tables once and walks
    its items with a grid-stride loop."""
    return max(1, min(work, sms * _DCT_CTAS_PER_SM))


class DecodePlan(NamedTuple):
    """Launch plan of :func:`dct8_decode_u8`: ``ctas`` CTAs, each storing its
    strips ``vec`` bytes at a time from a shared-memory strip whose rows are
    ``pitch`` bytes apart."""

    ctas: int
    vec: int
    pitch: int


def dct8_decode_plan(b: int, nby: int, nbx: int, c: int, width: int, out_ptr: int,
                     sms: int) -> DecodePlan:
    """The plan of :func:`dct8_decode_u8`: one CTA per (image, block-row)
    up to :func:`dct8_ctas`; the store width is the widest of 16, 8, 4, 2, 1
    bytes that divides the output row (``width * c`` bytes) and its address."""
    row = width * c
    vec = next(v for v in _WIDTHS if row % v == 0 and out_ptr % v == 0)
    # The strip's rows sit 16 bytes off a multiple of 128, so the 8 rows of
    # a block fall in different shared-memory banks.
    pitch = -(-nbx * 8 * c // 128) * 128 + 16
    return DecodePlan(dct8_ctas(b * nby, sms), vec, pitch)


def dct8_dequant_idct_plain(coef, quant, idct_m) -> torch.Tensor:
    """Plain version of :func:`dct8_dequant_idct`. ``deq = coef * q``
    rounds once; the 16 products are then summed in k order, one rounded
    elementwise op at a time, so CPU and CUDA give the same bits and the
    kernel can match them."""
    deq = coef.to(torch.float32) * quant
    acc = deq[:, 0:1] * idct_m[0]
    for k in range(1, idct_m.shape[0]):
        acc = acc + deq[:, k : k + 1] * idct_m[k]
    return acc


def dct8_dequant_idct(coef, quant, idct_m) -> torch.Tensor:
    """(NB, 16) int8 zonal DCT coefficients -> (NB, 64) float32 pixel
    blocks, level-shifted (the caller adds 128, rounds and clips).

    ``quant`` is the (16,) float32 dequantization table, ``idct_m`` the
    (16, 64) float32 coefficients -> pixels matrix
    (:data:`waternet_tpu_torch.data.codec.DCT8_IDCT_MATRIX`). CUDA: 16
    threads per block-channel, :func:`dct8_ctas` CTAs (csrc/codec.cu)."""
    if not _route(coef):
        return dct8_dequant_idct_plain(coef, quant, idct_m)
    if coef.ndim != 2:
        raise ValueError(f"coef: expected (NB, 16), got {tuple(coef.shape)}")
    nb = coef.shape[0]
    dev = coef.device
    _check("coef", coef, torch.int8, (nb, 16), dev)
    _check("quant", quant, torch.float32, (16,), dev)
    _check("idct_m", idct_m, torch.float32, (16, 64), dev)
    for name, t in (("coef", coef), ("idct_m", idct_m)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (read as 16-byte vectors)")
    from waternet_tpu_torch.ops import _build

    lib = _build.load()
    out = torch.empty((nb, 64), dtype=torch.float32, device=dev)
    ctas = dct8_ctas(-(-nb // (_DCT_THREADS // 16)), _sms(dev))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.waternet_dct8_dequant_idct(
            coef.data_ptr(), quant.data_ptr(), idct_m.data_ptr(), out.data_ptr(),
            nb, ctas, stream,
        )
    if err:
        raise RuntimeError(f"dct8_dequant_idct_kernel launch failed: cudaError {err}")
    LAUNCHES["dct8_dequant_idct"] += 1
    return out


def dct8_blocks_to_u8(pix: torch.Tensor, shape, height: int, width: int) -> torch.Tensor:
    """The dct8 decode's epilogue in plain torch: (NB, 64) f32 pixel blocks
    of a ``shape`` = (B, nby, nbx, C) payload -> (B, height, width, C)
    uint8: relayout to image order, crop, ``clamp(round(x + 128), 0, 255)``."""
    b, nby, nbx, c = shape
    img = pix.reshape(b, nby, nbx, c, 8, 8).permute(0, 1, 4, 2, 5, 3)
    img = img.reshape(b, nby * 8, nbx * 8, c)[:, :height, :width]
    return torch.clamp(torch.round(img + 128.0), 0, 255).to(torch.uint8)


def dct8_decode_u8_plain(coef5, quant, idct_m, height: int, width: int) -> torch.Tensor:
    """Plain version of :func:`dct8_decode_u8`: the plain f32 product, then
    :func:`dct8_blocks_to_u8`."""
    pix = dct8_dequant_idct_plain(coef5.reshape(-1, coef5.shape[-1]), quant, idct_m)
    return dct8_blocks_to_u8(pix, coef5.shape[:4], height, width)


def dct8_decode_u8(coef5, quant, idct_m, height: int, width: int) -> torch.Tensor:
    """The whole dct8 decode: the gathered (B, nby, nbx, C, 16) int8 payload
    -> (B, height, width, C) uint8 pixels, cropped to ``height x width``.

    CUDA: one launch of :func:`dct8_dequant_idct`'s product with the
    relayout and ``clamp(rint(x + 128), 0, 255)`` fused (csrc/codec.cu,
    planned by :func:`dct8_decode_plan`); it counts under
    ``LAUNCHES["dct8_dequant_idct"]``."""
    if not _route(coef5):
        return dct8_decode_u8_plain(coef5, quant, idct_m, height, width)
    if coef5.ndim != 5:
        raise ValueError(f"coef5: expected (B, nby, nbx, C, 16), got {tuple(coef5.shape)}")
    b, nby, nbx, c, _ = coef5.shape
    dev = coef5.device
    _check("coef5", coef5, torch.int8, (b, nby, nbx, c, 16), dev)
    _check("quant", quant, torch.float32, (16,), dev)
    _check("idct_m", idct_m, torch.float32, (16, 64), dev)
    if not (0 < height <= nby * 8 and 0 < width <= nbx * 8):
        raise ValueError(f"crop {height}x{width} outside the {nby * 8}x{nbx * 8} blocks")
    for name, t in (("coef5", coef5), ("idct_m", idct_m)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (read as 16-byte vectors)")
    from waternet_tpu_torch.ops import _build

    lib = _build.load()
    out = torch.empty((b, height, width, c), dtype=torch.uint8, device=dev)
    if out.numel() == 0:
        return out
    plan = dct8_decode_plan(b, nby, nbx, c, width, out.data_ptr(), _sms(dev))
    if 8 * plan.pitch + _DCT_TABLE_SMEM > _MAX_SMEM:
        raise ValueError(f"a {nbx * 8}-pixel block-row needs {8 * plan.pitch} B of shared memory")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.waternet_dct8_decode_u8(
            coef5.data_ptr(), quant.data_ptr(), idct_m.data_ptr(), out.data_ptr(), b, nby,
            nbx, c, height, width, plan.pitch, plan.vec, plan.ctas, stream,
        )
    if err:
        raise RuntimeError(f"dct8_decode_u8_kernel launch failed: cudaError {err}")
    LAUNCHES["dct8_dequant_idct"] += 1
    return out
