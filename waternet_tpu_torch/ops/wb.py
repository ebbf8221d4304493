"""White balance (simplest color balance), batched.

Per image and channel: saturation ``sat_c = 0.005 * maxsum / sum_c``, clip
to the linear-interpolation quantiles ``[q(sat_c), q(1 - sat_c)]``,
min-max stretch to [0, 255], truncate. The device path
(:func:`white_balance`) is the JAX package's histogram-CDF formulation
(waternet_tpu/ops/wb.py:66-119) with the batch dimension written out: the
quantiles come from 256-bin histograms, not a sort, and the channel sums
are taken from the histogram, the same computation at every image size.
"""

from __future__ import annotations

import numpy as np
import torch

_SAT = 0.005


def white_balance_np(img: np.ndarray) -> np.ndarray:
    """Host path. uint8 HWC (or HW) -> uint8 same shape; bit-exact with the
    reference."""
    if img.ndim == 2:
        flat = img.reshape(1, -1).astype(np.float64)
        lo_q = np.array([0.001])
        hi_q = 1.0 - np.array([0.005])
    else:
        h, w, c = img.shape
        flat = img.reshape(h * w, c).T.astype(np.float64)  # (C, H*W)
        sums = flat.sum(axis=1)
        # Degenerate frames (an all-black channel) would divide 0/0.
        sat = _SAT * (sums.max() / np.maximum(sums, 1.0))
        lo_q, hi_q = np.clip(sat, 0.0, 0.5), 1.0 - np.clip(sat, 0.0, 0.5)

    out = np.empty_like(flat)
    for ch in range(flat.shape[0]):
        lo, hi = np.quantile(flat[ch], [lo_q[ch], hi_q[ch]])
        v = np.clip(flat[ch], lo, hi)
        if hi > lo:
            out[ch] = (v - lo) * 255.0 / (hi - lo)
        else:
            out[ch] = v  # constant channel: stretch undefined, pass through

    if img.ndim == 2:
        return out.reshape(img.shape).astype(np.uint8)
    return out.T.reshape(img.shape).astype(np.uint8)


def white_balance(rgb: torch.Tensor) -> torch.Tensor:
    """Device path. (N, H, W, 3) uint8-valued -> (N, H, W, 3) float32 with
    exact uint8 values (floored)."""
    n_img, h, w, _ = rgb.shape
    n = h * w
    dev = rgb.device
    x = rgb.to(torch.float32)

    # One histogram for the whole batch: bin = image * 768 + channel * 256
    # + v. scatter_add_, not bincount: on CUDA bincount reads the maximum
    # back to the host to size its output, a sync mid-request.
    offset = (
        torch.arange(n_img, device=dev).view(n_img, 1, 1, 1) * 768
        + torch.arange(3, device=dev).view(1, 1, 1, 3) * 256
    )
    idx = (rgb.long() + offset).reshape(-1)
    ones = torch.ones((), dtype=torch.int64, device=dev).expand(idx.shape)
    hist = torch.zeros(n_img * 768, dtype=torch.int64, device=dev)
    hist = hist.scatter_add_(0, idx, ones).view(n_img, 3, 256)
    cdf = torch.cumsum(hist, dim=-1)  # cdf[i, c, v] = #pixels <= v

    # Channel sums from the histogram, exact in int64 and rounded once to
    # float32: the JAX path's float32 sum where that sum is exact (images up
    # to 65,793 pixels), and independent of summation order, so CPU and
    # CUDA agree at every size.
    levels = torch.arange(256, device=dev)
    sums = (hist * levels).sum(dim=-1).to(torch.float32)  # (N, 3)
    sat = torch.clamp(
        _SAT * (sums.amax(dim=-1, keepdim=True) / torch.clamp_min(sums, 1.0)),
        0.0,
        0.5,
    )

    def _q(p):  # (N, 3) probabilities -> (N, 3) quantiles
        pos = p * (n - 1)
        i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, n - 1)
        i1 = torch.clamp(i0 + 1, 0, n - 1)
        w1 = pos - i0.to(torch.float32)
        a = (cdf < (i0[..., None] + 1)).sum(dim=-1).to(torch.float32)
        b = (cdf < (i1[..., None] + 1)).sum(dim=-1).to(torch.float32)
        return a * (1.0 - w1) + b * w1

    lo = _q(sat).view(n_img, 1, 1, 3)
    hi = _q(1.0 - sat).view(n_img, 1, 1, 3)
    v = torch.minimum(torch.maximum(x, lo), hi)
    stretched = (v - lo) * 255.0 / torch.clamp_min(hi - lo, 1e-9)
    return torch.floor(torch.where(hi > lo, stretched, v))
