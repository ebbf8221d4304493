"""WaterNet's classical inputs, written plainly from their definitions:
white balance (simplest colour balance), gamma 0.7, and CLAHE on the L
channel of CIELAB (OpenCV's ``createCLAHE(clipLimit=0.1,
tileGridSize=(8, 8))`` algorithm), as the published reference computes
them with OpenCV.

RGB -> LAB is OpenCV's fixed-point 8-bit conversion; LAB -> RGB is the
float formula of OpenCV's documentation, rounded, so a level may differ
from OpenCV's own 8-bit inverse at a rounding edge. Statistics (white balance quantiles,
CLAHE tile histograms) are taken over the native image; :func:`transforms`
can then apply the resulting maps to a larger canvas whose top-left
region is that image (the bucketed serving path's semantics). Tensors are
(H, W, 3) or (H, W) uint8 values on any device; nothing here imports the
program under test.
"""

from __future__ import annotations

import numpy as np
import torch

SAT = 0.005
GAMMA = 0.7
CLIP_LIMIT = 0.1
TILES = 8

_RGB2XYZ = ((0.412453, 0.357580, 0.180423),
            (0.212671, 0.715160, 0.072169),
            (0.019334, 0.119193, 0.950227))
_XYZ2RGB = ((3.240479, -1.537150, -0.498535),
            (-0.969256, 1.875992, 0.041556),
            (0.055648, -0.204043, 1.057311))
_WHITE = (0.950456, 1.0, 1.088754)


def wb_stats(img: torch.Tensor):
    """(lo, hi), each (3,) float64: the quantiles ``sat_c`` and ``1 - sat_c``
    of each channel (linear interpolation, numpy's default), with
    ``sat_c = 0.005 * max(sums) / sum_c`` clipped to [0, 0.5]."""
    flat = img.reshape(-1, 3).to(torch.float64)
    n = flat.shape[0]
    sums = flat.sum(dim=0)
    sat = torch.clamp(SAT * sums.max() / torch.clamp_min(sums, 1.0), 0.0, 0.5)
    srt = torch.sort(flat, dim=0).values

    def quantile(p):
        pos = p * (n - 1)
        i0 = torch.floor(pos).long()
        i1 = torch.clamp(i0 + 1, max=n - 1)
        frac = pos - i0.to(torch.float64)
        ch = torch.arange(3, device=img.device)
        a, b = srt[i0, ch], srt[i1, ch]
        return a + (b - a) * frac

    return quantile(sat), quantile(1.0 - sat)


def wb_apply(img: torch.Tensor, lo, hi) -> torch.Tensor:
    """Clip each channel to [lo, hi] and stretch it to [0, 255], truncated;
    a channel with ``hi == lo`` passes through."""
    v = torch.minimum(torch.maximum(img.to(torch.float64), lo), hi)
    span = hi - lo
    out = torch.where(span > 0, (v - lo) * 255.0 / torch.where(span > 0, span, 1.0), v)
    return torch.floor(out)


def gamma(img: torch.Tensor) -> torch.Tensor:
    """``uint8(clip(255 * (v / 255) ** 0.7, 0, 255))``, truncated."""
    v = img.to(torch.float64) / 255.0
    return torch.floor(torch.clamp(255.0 * torch.pow(v, GAMMA), 0.0, 255.0))


def _lab_tables():
    """OpenCV's 8-bit RGB -> LAB tables: sRGB to linear light times 255 * 8
    (256 entries), the cube root (with its linear toe) times 2^15 over
    3072 steps of 1 / (255 * 8), and the XYZ matrix over the D65 white
    point times 2^12, each rounded to an integer; built in float32, as
    OpenCV builds them."""
    x = np.arange(256, dtype=np.float32) / np.float32(255.0)
    lin = np.where(x <= np.float32(0.04045), x / np.float32(12.92),
                   np.power((x + np.float32(0.055)) / np.float32(1.055), np.float32(2.4)))
    gamma_tab = np.rint(lin.astype(np.float64) * (255.0 * 8)).astype(np.int64)
    t = np.arange(3072, dtype=np.float32) / np.float32(255.0 * 8)
    f = np.where(t < np.float32(216.0 / 24389.0), np.float32(841.0 / 108.0) * t + np.float32(16.0 / 116.0),
                 np.cbrt(t))
    cbrt_tab = np.rint(f.astype(np.float64) * (1 << 15)).astype(np.int64)
    m = np.array(_RGB2XYZ, np.float32).astype(np.float64) / np.array(_WHITE, np.float32).astype(np.float64)[:, None]
    coeffs = np.rint(m * (1 << 12)).astype(np.int64)
    return gamma_tab, cbrt_tab, coeffs


_GAMMA_TAB, _CBRT_TAB, _XYZ_COEFFS = _lab_tables()


def rgb_to_lab(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) sRGB uint8 values -> (..., 3) 8-bit LAB (L * 255 / 100,
    a + 128, b + 128) by OpenCV's fixed-point ``COLOR_RGB2LAB`` for 8-bit
    images (round-to-nearest shifts), as float64."""
    dev = img.device
    gtab = torch.from_numpy(_GAMMA_TAB).to(dev)
    ctab = torch.from_numpy(_CBRT_TAB).to(dev)
    rgb = gtab[img.long()]

    def descale(v, n):
        return (v + (1 << (n - 1))) >> n

    f = [ctab[descale((rgb * torch.from_numpy(_XYZ_COEFFS[i]).to(dev)).sum(dim=-1), 12)] for i in range(3)]
    lum = descale(296 * f[1] - ((16 * 255 * (1 << 15) + 50) // 100), 15)
    a = descale(500 * (f[0] - f[1]) + (128 << 15), 15)
    b = descale(200 * (f[1] - f[2]) + (128 << 15), 15)
    return torch.clamp(torch.stack([lum, a, b], dim=-1), 0, 255).to(torch.float64)


def lab_to_rgb(lab: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`rgb_to_lab` on 8-bit LAB values -> sRGB uint8
    values (rounded, clipped), as float64."""
    lab = lab.to(torch.float64)
    lum = lab[..., 0] * 100.0 / 255.0
    a, b = lab[..., 1] - 128.0, lab[..., 2] - 128.0
    dark = lum <= 7.9996248
    y = torch.where(dark, lum / 903.3, torch.pow((lum + 16.0) / 116.0, 3.0))
    fy = torch.where(dark, 7.787 * y + 16.0 / 116.0, (lum + 16.0) / 116.0)

    def finv(t):
        return torch.where(t > 0.206893, t ** 3, (t - 16.0 / 116.0) / 7.787)

    white = torch.tensor(_WHITE, dtype=torch.float64, device=lab.device)
    xyz = torch.stack([finv(fy + a / 500.0) * white[0], y, finv(fy - b / 200.0) * white[2]], dim=-1)
    lin = xyz @ torch.tensor(_XYZ2RGB, dtype=torch.float64, device=lab.device).T
    srgb = torch.where(lin > 0.0031308, 1.055 * torch.pow(torch.clamp_min(lin, 0.0), 1.0 / 2.4) - 0.055,
                       12.92 * lin)
    return torch.clamp(torch.round(srgb * 255.0), 0.0, 255.0)


def _reflect101(idx_max: int, n: int, device) -> torch.Tensor:
    """Row (or column) indices of a plane of ``idx_max`` rows extended to
    ``n`` rows by reflection without repeating the edge."""
    i = torch.arange(n, device=device)
    return torch.where(i < idx_max, i, 2 * (idx_max - 1) - i)


def clahe_luts(lum: torch.Tensor):
    """OpenCV's CLAHE tables of one (H, W) L plane: ``(luts, th, tw)``, the
    (8, 8, 256) float32 lookup tables and the tile size.

    When H or W is not a multiple of 8, both axes are padded bottom/right
    by ``8 - size % 8`` (reflect-101), as OpenCV does. Each tile's
    histogram is clipped at ``max(int(0.1 * area / 256), 1)``, the excess
    spread evenly and its remainder one count at a time from bin 0 with a
    stride of ``max(256 // remainder, 1)``; the table is the cumulative sum
    times the float32 ``255 / area``, rounded."""
    h, w = lum.shape
    pad_h, pad_w = (0, 0) if (h % TILES == 0 and w % TILES == 0) else (TILES - h % TILES, TILES - w % TILES)
    hp, wp = h + pad_h, w + pad_w
    plane = lum.long()[_reflect101(h, hp, lum.device)][:, _reflect101(w, wp, lum.device)]
    th, tw = hp // TILES, wp // TILES
    area = th * tw
    tiles = plane.reshape(TILES, th, TILES, tw).permute(0, 2, 1, 3).reshape(TILES * TILES, area)
    hist = torch.zeros((TILES * TILES, 256), dtype=torch.int64, device=lum.device)
    hist.scatter_add_(1, tiles, torch.ones_like(tiles))
    clip = max(int(CLIP_LIMIT * area / 256.0), 1)
    excess = torch.clamp_min(hist - clip, 0).sum(dim=1, keepdim=True)
    hist = torch.clamp_max(hist, clip) + excess // 256
    remainder = excess % 256
    step = torch.clamp_min(256 // torch.clamp_min(remainder, 1), 1)
    bins = torch.arange(256, device=lum.device)[None, :]
    hist = hist + ((remainder > 0) & (bins % step == 0) & (bins // step < remainder)).long()
    scale = np.float32(255.0) / np.float32(area)
    cdf = torch.cumsum(hist, dim=1).to(torch.float32)
    luts = torch.clamp(torch.round(cdf * float(scale)), 0.0, 255.0)
    return luts.reshape(TILES, TILES, 256), th, tw


def clahe_apply(lum: torch.Tensor, luts: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """Interpolate the tile tables at every pixel of an (H, W) L plane
    (which may extend past the image the tables came from): the two
    nearest tile rows and columns from float32 ``i / tile - 0.5``, clamped
    to the grid, blended bilinearly in float32 and rounded."""
    dev = lum.device

    def axis(n, tile):
        c = torch.arange(n, dtype=torch.float32, device=dev) * (np.float32(1.0) / np.float32(tile)) - 0.5
        fl = torch.floor(c)
        lo = fl.long()
        return lo.clamp(0, TILES - 1), (lo + 1).clamp(0, TILES - 1), c - fl

    y1, y2, ya = axis(lum.shape[0], th)
    x1, x2, xa = axis(lum.shape[1], tw)
    flat = luts.reshape(TILES * TILES, 256)
    v = lum.long()

    def look(ty, tx):
        return flat[ty[:, None] * TILES + tx[None, :], v]

    ya, xa = ya[:, None], xa[None, :]
    res = (look(y1, x1) * (1.0 - xa) + look(y1, x2) * xa) * (1.0 - ya) + (
        look(y2, x1) * (1.0 - xa) + look(y2, x2) * xa) * ya
    return torch.clamp(torch.round(res), 0.0, 255.0)


def transforms(img: torch.Tensor, canvas: torch.Tensor | None = None):
    """(wb, gc, he) of one (H, W, 3) uint8 image, float32 uint8 values.

    With ``canvas`` (a (CH, CW, 3) image whose top-left (H, W) region is
    ``img``), the statistics come from ``img`` and the maps are applied
    over the whole canvas, which is then what the three planes cover."""
    target = img if canvas is None else canvas
    lo, hi = wb_stats(img)
    wb = wb_apply(target, lo, hi)
    gc = gamma(target)
    lab = rgb_to_lab(target)
    luts, th, tw = clahe_luts(rgb_to_lab(img)[..., 0])
    lab = torch.cat([clahe_apply(lab[..., 0], luts, th, tw)[..., None].to(torch.float64), lab[..., 1:]], dim=-1)
    he = lab_to_rgb(lab)
    return tuple(t.to(torch.float32) for t in (wb, gc, he))


def pad_to_bucket(img: np.ndarray, bh: int, bw: int) -> np.ndarray:
    """Pad an (H, W, C) array bottom/right to (bh, bw): reflection without
    repeating the edge where the pad is shorter than the image, else the
    edge repeated (the serving contract's padding)."""
    h, w = img.shape[:2]
    out = img
    if bh > h:
        out = np.pad(out, ((0, bh - h), (0, 0), (0, 0)), mode="reflect" if bh - h <= h - 1 else "edge")
    if bw > w:
        out = np.pad(out, ((0, 0), (0, bw - w), (0, 0)), mode="reflect" if bw - w <= w - 1 else "edge")
    return out


def to_u8(out: torch.Tensor) -> torch.Tensor:
    """A [0, 1] float image -> uint8 levels, clipped and truncated (the
    published reference's ``postprocess``)."""
    return (out.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
