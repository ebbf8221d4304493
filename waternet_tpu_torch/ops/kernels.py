"""Wrappers of the port's CUDA kernels (``csrc/clahe.cu``,
``csrc/codec.cu``), their plain PyTorch versions, and the launch counters.

A wrapper given a CPU tensor runs the plain version. Given a CUDA tensor
it launches the kernel, after checking device, dtype, shape and
contiguity, and raises on anything else; there is no fallback from the
kernel to the plain version. ``LAUNCHES[name]`` counts kernel launches,
and only those.

==================  ===============================================  =========
wrapper             replaces (TPU kernel)                            bound by
==================  ===============================================  =========
tile_lut            pallas_kernels.py:133 ``_lut_kernel`` (:201)     bytes
tile_histogram      pallas_kernels.py:71 ``_hist_kernel`` (:106)     bytes
clahe_lut_planes    pallas_kernels.py:229 ``_interp_kernel`` (:269)  bytes
dct8_dequant_idct   pallas_kernels.py:330 ``_dct8_kernel`` (:366)    bytes
==================  ===============================================  =========

The plain versions are the reference arithmetic (bincount, cumsum,
advanced indexing, one rounded op at a time). The tests hold them against
the JAX kernels; on the card, ``chip_smoke.py`` holds each kernel against
them. Nothing on the main path calls them on a CUDA tensor.
"""

from __future__ import annotations

import numpy as np
import torch

LAUNCHES = {"tile_lut": 0, "clahe_lut_planes": 0, "tile_histogram": 0, "dct8_dequant_idct": 0}

_BINS = 256
_MAX_SMEM = 232_448  # dynamic shared memory a Hopper CTA may opt into


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
    histograms. CUDA: one CTA per tile (csrc/clahe.cu), the histogram
    phase of :func:`tile_lut`."""
    if not _route(l_pad):
        return tile_histogram_plain(l_pad, tile_grid)
    n, hp, wp, ty, tx = _grid(l_pad, tile_grid)
    _check("l_pad", l_pad, torch.uint8, (n, hp, wp), l_pad.device)
    from waternet_tpu_torch.ops import _build

    lib = _build.load()
    out = torch.empty((n, ty, tx, _BINS), dtype=torch.int32, device=l_pad.device)
    with torch.cuda.device(l_pad.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.waternet_clahe_tile_histogram(
            l_pad.data_ptr(), out.data_ptr(), n, hp, wp, ty, tx, stream
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


def tile_lut(l_pad: torch.Tensor, tile_grid, clip: int, scale) -> torch.Tensor:
    """(N, hp, wp) uint8 padded L planes -> (N, ty, tx, 256) float32 CLAHE
    LUTs. ``clip`` is the integer clip limit, ``scale`` the float32
    ``255 / tile_area``. CUDA: one CTA per tile (csrc/clahe.cu)."""
    if not _route(l_pad):
        return tile_lut_plain(l_pad, tile_grid, clip, scale)
    n, hp, wp, ty, tx = _grid(l_pad, tile_grid)
    _check("l_pad", l_pad, torch.uint8, (n, hp, wp), l_pad.device)
    from waternet_tpu_torch.ops import _build

    lib = _build.load()
    out = torch.empty((n, ty, tx, _BINS), dtype=torch.float32, device=l_pad.device)
    with torch.cuda.device(l_pad.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.waternet_clahe_tile_lut(
            l_pad.data_ptr(), out.data_ptr(), n, hp, wp, ty, tx, int(clip),
            float(np.float32(scale)), stream,
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
    threads per block-channel (csrc/codec.cu)."""
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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.waternet_dct8_dequant_idct(
            coef.data_ptr(), quant.data_ptr(), idct_m.data_ptr(), out.data_ptr(),
            nb, stream,
        )
    if err:
        raise RuntimeError(f"dct8_dequant_idct_kernel launch failed: cudaError {err}")
    LAUNCHES["dct8_dequant_idct"] += 1
    return out
