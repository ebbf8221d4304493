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
dct8_dequant_idct   pallas_kernels.py:330 ``_dct8_kernel`` (:366)    bytes
dct8_decode_u8      the same, with the decode's uint8 epilogue       operations
==================  ===============================================  ==========

``dct8_decode_u8`` is the same TPU kernel with another epilogue, so its
launches count under ``LAUNCHES["dct8_dequant_idct"]``. The launch plans
(:func:`tile_plan`, :func:`dct8_ctas`, :func:`dct8_decode_plan`) are pure
functions of the shapes, the card's SM count and the data's address.

The plain versions are the reference arithmetic (bincount, cumsum,
advanced indexing, one rounded op at a time). The tests hold them against
the JAX kernels; on the card, ``chip_smoke.py`` holds each kernel against
them. Nothing on the main path calls them on a CUDA tensor.
"""

from __future__ import annotations

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


def luts_from_hist(hist: torch.Tensor, clip: int, scale) -> torch.Tensor:
    """(T, 256) integer histograms -> (T, 256) float32 LUTs: OpenCV's integer
    clip and excess redistribution, then ``clip(rint(cdf * scale), 0, 255)``
    with the single-rounded float32 ``scale`` (clahe.py:275-288)."""
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
    return torch.clamp(torch.round(cdf * float(np.float32(scale))), 0.0, 255.0)


def tile_histogram_plain(l_pad: torch.Tensor, tile_grid) -> torch.Tensor:
    """Plain version of :func:`tile_histogram`: one bincount."""
    n, hp, wp, ty, tx = _grid(l_pad, tile_grid)
    th, tw = hp // ty, wp // tx
    tiles = (
        l_pad.reshape(n, ty, th, tx, tw).permute(0, 1, 3, 2, 4).reshape(-1, th * tw)
    )
    n_tiles = tiles.shape[0]
    tile_ids = torch.arange(n_tiles, device=l_pad.device)[:, None] * _BINS
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
    """
    if not _route(l_pad):
        return clahe_lut_planes_plain(luts, l_pad, y1, y2, x1, x2)
    if l_pad.ndim != 3 or luts.ndim != 4:
        raise ValueError("expected luts (N, ty, tx, 256) and l_pad (N, hp, wp)")
    n, hp, wp = l_pad.shape
    ty, tx = luts.shape[1:3]
    dev = l_pad.device
    _check("luts", luts, torch.float32, (n, ty, tx, _BINS), dev)
    _check("l_pad", l_pad, torch.uint8, (n, hp, wp), dev)
    for name, t, size in (("y1", y1, hp), ("y2", y2, hp), ("x1", x1, wp), ("x2", x2, wp)):
        _check(name, t, torch.int32, (size,), dev)
    smem = ty * tx * _BINS * 4
    if smem > _MAX_SMEM:
        raise ValueError(f"{ty}x{tx} tile LUTs need {smem} B of shared memory")
    if luts.data_ptr() % 16:
        raise ValueError("luts must be 16-byte aligned (staged as float4)")
    from waternet_tpu_torch.ops import _build

    lib = _build.load()
    out = torch.empty((4, n, hp, wp), dtype=torch.float32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # About three resident CTAs per SM (64 KB of LUTs each) in one wave.
    rows_per_block = max(1, -(-n * hp // (3 * sms)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.waternet_clahe_lut_planes(
            luts.data_ptr(), l_pad.data_ptr(), y1.data_ptr(), y2.data_ptr(),
            x1.data_ptr(), x2.data_ptr(), out.data_ptr(), n, hp, wp, ty, tx,
            rows_per_block, stream,
        )
    if err:
        raise RuntimeError(f"clahe_lut_planes_kernel launch failed: cudaError {err}")
    LAUNCHES["clahe_lut_planes"] += 1
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
