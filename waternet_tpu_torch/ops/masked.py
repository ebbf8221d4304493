"""Native-first WB/GC/CLAHE on padded canvases: the device-preprocess
serving path (docs/SERVING.md "Replica pool").

The port of the JAX package's ``ops/masked.py``, in plain PyTorch on the
canvas's device. The bucketed serving engine pads every image up to a
bucket so one batch shape serves many resolutions. Its exactness policy
requires the per-image statistics (WB quantiles, CLAHE tile histograms)
to come from the NATIVE image, with the pad applied afterwards:
statistics of the padded canvas would change every pixel, not just the
seam band. Each transform here takes the raw uint8 canvases (each native
image reflect-padded bottom/right, :func:`waternet_tpu_torch.serving.
bucketing.pad_to_bucket`) and the native ``(h, w)`` of each as an int32
tensor, computes its statistics over the native region only, and applies
the resulting map to the whole canvas.

The batch is one pass: (N, CH, CW, 3) canvases and (N, 2) shapes in,
nothing read back to the host (no ``.item()``, ``.tolist()`` or
``.cpu()``, no ``bincount`` or boolean indexing, each of which waits for
the device). It runs on a serving replica's launch thread, where a host
sync would serialise the pool.

Native region, bit for bit against the port's own device transforms
(:mod:`waternet_tpu_torch.ops.transform`, whose CLAHE runs the CUDA
kernels on the card):

* **WB**: the per-channel 256-bin histogram is an integer
  ``scatter_add_`` with the pixels outside the native region routed to a
  dump bin. Integer adds do not depend on their order, so the histogram,
  its CDF and the channel sums (exact in int64, rounded once, as the
  native path) are the native image's. The clip/stretch/floor that
  follows is pointwise.
* **GC**: a 256-entry lookup; pointwise.
* **CLAHE**: each image's tile grid comes from its own ``(h, w)``:
  OpenCV's divisibility padding (re-derived by a reflect-101 index map
  *into* the native region, whatever the canvas holds beyond it), the
  tile extents, the integer clip limit (``area // 2560``) and the
  single-rounded float32 LUT scale, through
  :func:`waternet_tpu_torch.ops.kernels.luts_from_hist` with per-tile
  clip and scale. The interpolation coordinates are OpenCV's float32
  reciprocal multiply, and the blend is
  :func:`~waternet_tpu_torch.ops.kernels.blend_quadrants`, one rounded
  eager op at a time: the plain version of the card's blend kernel.

For WB and GC the map is pointwise once its statistics are fixed, so the
pad region comes out as the transform of the reflected content: the
reflect pad of the transformed native image, which is what the host
serving path (``InferenceEngine.preprocess_padded``) builds. CLAHE's map
depends on position (the blend weights follow the canvas coordinate), so
its pad region holds equalized reflected content instead: irrelevant to
output pixels farther than the 13-pixel receptive radius from the seam.
"""

from __future__ import annotations

from typing import Tuple

import torch

from waternet_tpu_torch.ops import kernels
from waternet_tpu_torch.ops.clahe import CLIP_LIMIT, TILE_GRID
from waternet_tpu_torch.ops.color import lab_u8_to_rgb, rgb_to_lab_u8
from waternet_tpu_torch.ops.gamma import gamma_correction
from waternet_tpu_torch.ops.wb import _SAT

_BINS = 256


def _native_mask(n: int, ch: int, cw: int, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(N, CH, CW) bool: True inside each image's native top-left region."""
    yy = torch.arange(ch, device=h.device)
    xx = torch.arange(cw, device=h.device)
    return (yy[None, :, None] < h[:, None, None]) & (xx[None, None, :] < w[:, None, None])


def white_balance_masked(canvas: torch.Tensor, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Simplest color balance with native-region statistics.

    ``canvas``: (N, CH, CW, 3) uint8-valued; ``h``/``w``: (N,) integer
    native extents on the same device. Returns (N, CH, CW, 3) float32 with
    exact uint8 values over the whole canvas; the native region is
    :func:`waternet_tpu_torch.ops.wb.white_balance` of the native image,
    bit for bit."""
    n_img, ch, cw, _ = canvas.shape
    dev = canvas.device
    h, w = h.long(), w.long()
    x = canvas.to(torch.float32)
    mask = _native_mask(n_img, ch, cw, h, w)

    offset = (
        torch.arange(n_img, device=dev).view(n_img, 1, 1, 1) * 768
        + torch.arange(3, device=dev).view(1, 1, 1, 3) * _BINS
    )
    dump = n_img * 768
    idx = torch.where(mask[..., None], canvas.long() + offset, dump).reshape(-1)
    ones = torch.ones((), dtype=torch.int64, device=dev).expand(idx.shape)
    hist = torch.zeros(dump + 1, dtype=torch.int64, device=dev)
    hist = hist.scatter_add_(0, idx, ones)[:dump].view(n_img, 3, _BINS)
    cdf = torch.cumsum(hist, dim=-1)

    levels = torch.arange(_BINS, device=dev)
    sums = (hist * levels).sum(dim=-1).to(torch.float32)  # (N, 3)
    sat = torch.clamp(
        _SAT * (sums.amax(dim=-1, keepdim=True) / torch.clamp_min(sums, 1.0)),
        0.0,
        0.5,
    )
    last = (h * w - 1)[:, None]  # (N, 1): the native pixel count - 1

    def _q(p):  # (N, 3) probabilities -> (N, 3) quantiles
        pos = p * last.to(torch.float32)
        i0 = torch.minimum(torch.clamp_min(torch.floor(pos).to(torch.int64), 0), last)
        i1 = torch.minimum(i0 + 1, last)
        w1 = pos - i0.to(torch.float32)
        a = (cdf < (i0[..., None] + 1)).sum(dim=-1).to(torch.float32)
        b = (cdf < (i1[..., None] + 1)).sum(dim=-1).to(torch.float32)
        return a * (1.0 - w1) + b * w1

    lo = _q(sat).view(n_img, 1, 1, 3)
    hi = _q(1.0 - sat).view(n_img, 1, 1, 3)
    v = torch.minimum(torch.maximum(x, lo), hi)
    stretched = (v - lo) * 255.0 / torch.clamp_min(hi - lo, 1e-9)
    return torch.floor(torch.where(hi > lo, stretched, v))


def _mirror(n_pix: int, extent: torch.Tensor, limit: int) -> torch.Tensor:
    """(N, n_pix) source indices: ``i`` inside ``[0, extent)``, reflect-101
    beyond it (``2 * extent - 2 - i``), clamped to ``[0, limit)``."""
    i = torch.arange(n_pix, device=extent.device)[None, :]
    e = extent[:, None]
    mirrored = torch.clamp(2 * e - 2 - i, min=torch.zeros_like(e), max=torch.clamp_min(e - 1, 0))
    return torch.clamp(torch.where(i < e, i, mirrored), 0, limit - 1)


def _interp_axis(n_pix: int, tile: torch.Tensor, n_tiles: int):
    """Per-image coordinates along one axis of the canvas: (lo, hi) tile
    indices and the blend weight of ``hi``, from OpenCV's float32
    ``i * (1 / tile) - 0.5``, as :func:`~waternet_tpu_torch.ops.kernels.
    tile_indices` computes them for one shape; past the padded native
    extent (the canvas's pad) the indices clamp to the grid, as JAX's
    gathers clamp. Each (N, n_pix)."""
    tile = tile.to(torch.float32)
    inv = torch.ones_like(tile) / tile
    c = torch.arange(n_pix, dtype=torch.float32, device=tile.device)[None, :] * inv[:, None] - 0.5
    fl = torch.floor(c)
    lo = fl.to(torch.int64)
    return torch.clamp(lo, 0, n_tiles - 1), torch.clamp_max(lo + 1, n_tiles - 1), c - fl


def clahe_masked(l_canvas: torch.Tensor, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """OpenCV-exact CLAHE (clipLimit=0.1, 8x8 tiles) with each image's
    native extent.

    ``l_canvas``: (N, CH, CW) uint8-valued L planes whose top-left (h, w)
    regions are the native images; ``h``/``w``: (N,) integer extents.
    Returns (N, CH, CW) float32 holding exact uint8 values; the native
    region is :func:`waternet_tpu_torch.ops.clahe.clahe` of the native
    plane, bit for bit."""
    n_img, ch, cw = l_canvas.shape
    dev = l_canvas.device
    ty, tx = TILE_GRID
    h, w = h.long(), w.long()
    vals = l_canvas.long()

    # OpenCV's divisibility pad: when EITHER axis is not divisible, BOTH
    # pad by ``tiles - size % tiles`` (a full tile count on an axis that
    # divided already).
    divisible = (h % ty == 0) & (w % tx == 0)
    hp = h + torch.where(divisible, 0, ty - h % ty)
    wp = w + torch.where(divisible, 0, tx - w % tx)
    th, tw = hp // ty, wp // tx
    area = th * tw

    # Per-tile histograms over each padded native image, gathered through
    # the reflect-101 index map on a grid wide enough for the largest pad
    # (a full tile count per axis); integer adds into a dump bin.
    gh, gw = ch + ty, cw + tx
    sy, sx = _mirror(gh, h, ch), _mirror(gw, w, cw)
    img = torch.arange(n_img, device=dev)[:, None, None]
    grid = vals[img, sy[:, :, None], sx[:, None, :]]  # (N, gh, gw)
    ys = torch.arange(gh, device=dev)[None, :]
    xs = torch.arange(gw, device=dev)[None, :]
    tile_y = torch.clamp(ys // th[:, None], 0, ty - 1)
    tile_x = torch.clamp(xs // tw[:, None], 0, tx - 1)
    in_range = (ys < hp[:, None])[:, :, None] & (xs < wp[:, None])[:, None, :]
    tile_id = img * (ty * tx) + tile_y[:, :, None] * tx + tile_x[:, None, :]
    dump = n_img * ty * tx * _BINS
    hidx = torch.where(in_range, tile_id * _BINS + grid, dump).reshape(-1)
    ones = torch.ones((), dtype=torch.int64, device=dev).expand(hidx.shape)
    hist = torch.zeros(dump + 1, dtype=torch.int64, device=dev)
    hist = hist.scatter_add_(0, hidx, ones)[:dump].view(n_img * ty * tx, _BINS)

    # clip = max(int(0.1 * area / 256), 1) == max(area // 2560, 1) for every
    # integer area; the scale is the single-rounded float32 255 / area.
    denom = int(round(_BINS / CLIP_LIMIT))
    clip = torch.clamp_min(area // denom, 1).repeat_interleave(ty * tx)
    area_f = area.to(torch.float32)
    scale = torch.full_like(area_f, 255.0) / area_f
    luts = kernels.luts_from_hist(hist, clip, scale.repeat_interleave(ty * tx))
    luts = luts.view(n_img, ty, tx, _BINS)

    y1, y2, ya = _interp_axis(ch, th, ty)
    x1, x2, xa = _interp_axis(cw, tw, tx)
    rows = [y[:, :, None] for y in (y1, y2)]
    cols = [x[:, None, :] for x in (x1, x2)]
    p11, p12, p21, p22 = (luts[img, r, c, vals] for r in rows for c in cols)
    return kernels.blend_quadrants(p11, p12, p21, p22, ya[:, :, None], xa[:, None, :])


def histeq_masked(canvas: torch.Tensor, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Native-statistics ``histeq`` on canvases: RGB -> LAB (pointwise,
    exact fixed point), :func:`clahe_masked` on L, LAB -> RGB (pointwise:
    per pixel the native path's float inverse)."""
    lab = rgb_to_lab_u8(canvas)
    el = clahe_masked(lab[..., 0], h, w)
    return lab_u8_to_rgb(torch.cat([el[..., None], lab[..., 1:]], dim=-1))


def transform_masked(canvas: torch.Tensor, h, w) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One (CH, CW, 3) canvas and its native ``h``/``w`` (ints or scalar
    tensors) -> (wb, gc, he) float32 canvases with native-first statistics,
    in :func:`~waternet_tpu_torch.ops.transform.transform_batch`'s return
    order (callers reorder to the network's (x, wb, he, gc))."""
    hw = torch.as_tensor([[int(h), int(w)]], dtype=torch.int32, device=canvas.device)
    wb, gc, he = transform_masked_batch(canvas[None], hw)
    return wb[0], gc[0], he[0]


def transform_masked_batch(canvas: torch.Tensor, hw: torch.Tensor):
    """(N, CH, CW, 3) uint8 canvases and (N, 2) int32 native ``(h, w)`` on
    the same device -> (wb, gc, he), each (N, CH, CW, 3) float32 holding
    exact uint8 values. One batched pass with no host sync."""
    h, w = hw[:, 0], hw[:, 1]
    return white_balance_masked(canvas, h, w), gamma_correction(canvas), histeq_masked(canvas, h, w)
