"""CLAHE and the ``histeq`` transform, over a batch.

``histeq``: RGB -> LAB (OpenCV's uint8 fixed-point path), OpenCV-exact
CLAHE with ``clipLimit=0.1, tileGridSize=(8, 8)`` on L, LAB -> RGB.

:func:`histeq_np` is the host path (cv2, bit-exact with the reference).
:func:`clahe` is the device path, exact in the integer pipeline as the
JAX package's (waternet_tpu/ops/clahe.py:452-596):

1. Pad bottom/right with reflect-101 so H and W divide the tile grid, with
   OpenCV's quirk: if either axis is not divisible, BOTH axes are padded
   by ``tiles - size % tiles``.
2. Per-tile LUTs (histogram, integer clip, redistribution, CDF, rounded
   scale): :func:`~waternet_tpu_torch.ops.kernels.tile_lut`.
3. The four surrounding tile LUTs looked up at every pixel, with per-row
   and per-column tile indices from OpenCV's float32 reciprocal multiply,
   computed on the host, and
4. their bilinear blend, rounded half to even, clamped and cropped, fused
   into the same kernel: :func:`~waternet_tpu_torch.ops.kernels.clahe_lut_blend`
   (each op rounded once in the eager order, so the kernel gives the
   plain version's bits).

Only the gather strategy is carried over: the JAX package's one-hot
matmul strategies and their knobs exist for the TPU's matrix unit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from waternet_tpu_torch.ops import kernels
from waternet_tpu_torch.ops.color import lab_u8_to_rgb, rgb_to_lab_u8

CLIP_LIMIT = 0.1
TILE_GRID = (8, 8)


def histeq_np(rgb: np.ndarray) -> np.ndarray:
    """Host path: uint8 HWC RGB -> uint8 HWC RGB, bit-exact with the
    reference."""
    import cv2

    lab = cv2.cvtColor(rgb, cv2.COLOR_RGB2LAB)
    clahe_op = cv2.createCLAHE(clipLimit=CLIP_LIMIT, tileGridSize=TILE_GRID)
    out = lab.copy()
    out[:, :, 0] = clahe_op.apply(lab[:, :, 0])
    return cv2.cvtColor(out, cv2.COLOR_LAB2RGB)


@functools.lru_cache(maxsize=64)
def _geometry(h: int, w: int, ty: int, tx: int, device: torch.device):
    """Per-shape constants on ``device``: reflect-101 row/column gather
    indices for the padding, the tile indices, and the blend weights."""
    if h % ty == 0 and w % tx == 0:
        pad_h = pad_w = 0
    else:
        pad_h, pad_w = ty - h % ty, tx - w % tx
    hp, wp = h + pad_h, w + pad_w
    th, tw = hp // ty, wp // tx
    rows = np.pad(np.arange(h), (0, pad_h), mode="reflect")
    cols = np.pad(np.arange(w), (0, pad_w), mode="reflect")

    def weight(n_pix, tile):  # frac(i * f32(1/tile) - 0.5), as cv2
        c = np.arange(n_pix, dtype=np.float32) * (
            np.float32(1.0) / np.float32(tile)
        ) - np.float32(0.5)
        return c - np.floor(c)

    def dev(a):
        # jaxlint: disable-next=R003 per-shape geometry (lru_cache): a blocking copy, safe on every stream
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return {
        "pad": (pad_h, pad_w),
        "rows": dev(rows),
        "cols": dev(cols),
        "tile": (th, tw),
        "y": tuple(dev(a) for a in kernels.tile_indices(hp, th, ty)),
        "x": tuple(dev(a) for a in kernels.tile_indices(wp, tw, tx)),
        "ya": dev(weight(h, th)[:, None]),
        "xa": dev(weight(w, tw)[None, :]),
    }


def clahe_inputs(l_chan: torch.Tensor, clip_limit=CLIP_LIMIT, tile_grid=TILE_GRID):
    """What the two kernels take for ``l_chan`` (N, H, W): the padded
    (N, hp, wp) uint8 plane, the integer clip limit, the float32 LUT scale,
    and the per-shape geometry (tile indices, blend weights)."""
    n, h, w = l_chan.shape
    ty, tx = tile_grid
    g = _geometry(h, w, ty, tx, l_chan.device)
    l_pad = l_chan.to(torch.uint8)
    if g["pad"] != (0, 0):
        l_pad = l_pad.index_select(1, g["rows"]).index_select(2, g["cols"])
    th, tw = g["tile"]
    area = th * tw
    clip = max(int(clip_limit * area / 256.0), 1)
    # Single-rounded float32 division, as OpenCV's lutScale.
    scale = np.float32(255.0) / np.float32(area)
    return l_pad.contiguous(), clip, scale, g


def clahe(
    l_chan: torch.Tensor,
    clip_limit: float = CLIP_LIMIT,
    tile_grid: tuple[int, int] = TILE_GRID,
    use_kernels: bool = True,
) -> torch.Tensor:
    """OpenCV-exact CLAHE on a batch of single-channel planes.

    Args:
        l_chan: (N, H, W) uint8-valued tensor (any real dtype).
        tile_grid: (ty, tx) tile counts along (H, W); cv2's
            ``tileGridSize`` is the transposed (tilesX, tilesY).
        use_kernels: False runs the kernels' plain versions on any device
            (the comparison ``chip_smoke.py`` makes on the card).
    Returns:
        (N, H, W) float32 holding exact uint8 values.
    """
    h, w = l_chan.shape[1:]
    l_pad, clip, scale, g = clahe_inputs(l_chan, clip_limit, tile_grid)
    if use_kernels:
        tile_lut, lut_blend = kernels.tile_lut, kernels.clahe_lut_blend
    else:
        tile_lut, lut_blend = kernels.tile_lut_plain, kernels.clahe_lut_blend_plain
    luts = tile_lut(l_pad, tile_grid, clip, scale)
    return lut_blend(luts, l_pad, *g["y"], *g["x"], g["ya"], g["xa"], h, w)


def histeq(rgb: torch.Tensor) -> torch.Tensor:
    """Device-path ``histeq``: (N, H, W, 3) uint8-valued RGB -> float32
    uint8 values. LAB forward and CLAHE are exact; the float LAB inverse
    is the one stage that may differ from the JAX path, by one level."""
    lab = rgb_to_lab_u8(rgb)
    el = clahe(lab[..., 0])
    lab = torch.cat([el[..., None], lab[..., 1:]], dim=-1)
    return lab_u8_to_rgb(lab)
