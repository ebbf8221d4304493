"""The numbers that decide ``correct``, and the lower-precision control.

Images: the program's uint8 results against the reference's, pooled over
the sample: the mean absolute difference in levels, the widest, and the
share of values at least ``t`` levels apart for a few ``t``. Training: each step's loss (the first
step's alone is steady from seed to seed: Adam's first step moves every
weight by about the learning rate whatever the size of its gradient, so
the gaps of later losses follow the first step's sign flips), the first
gradient's norm and the parameters' change, each leaf judged by the gap
between the two norms over the larger of the reference's norm of that
leaf and of the median leaf. Leaves whose reference gradient is under a
thousandth of the median leaf's are left out of the leaf gaps: Adam moves
them by round-off alone.
"""

from __future__ import annotations

import statistics

import torch
import torch.nn.functional as F

#: Share of the median leaf's gradient norm under which a leaf counts as
#: unmoved by the loss.
UNMOVED = 1e-3
#: Distances, in levels, whose tail shares :func:`image_numbers` reports.
OFF_LEVELS = (2, 3, 4, 6, 8)


def image_numbers(pairs) -> dict:
    """``pairs``: [(program uint8, reference uint8)] of equal shapes (any
    device). Returns ``mae_levels`` (mean |difference|), ``max_levels`` and,
    for each ``t`` of :data:`OFF_LEVELS`, ``off<t>_share``: the share of
    values at least ``t`` levels apart. A pair of other shapes, or no pair,
    reads as every value 255 levels apart."""
    hist = None
    for got, want in pairs:
        got = torch.as_tensor(got).to(want.device)
        if tuple(got.shape) != tuple(want.shape):
            hist = None
            break
        d = (got.to(torch.int64) - want.to(torch.int64)).abs().flatten()
        h = torch.bincount(d, minlength=256).double().cpu()
        hist = h if hist is None else hist + h
    if hist is None:
        return {"mae_levels": 255.0, "max_levels": 255.0, **{f"off{t}_share": 1.0 for t in OFF_LEVELS}}
    n = float(hist.sum())
    levels = torch.arange(256, dtype=torch.float64)
    out = {"mae_levels": float((hist * levels).sum()) / n,
           "max_levels": float(levels[hist > 0].max())}
    for t in OFF_LEVELS:
        out[f"off{t}_share"] = float(hist[t:].sum()) / n
    return out


def counted_leaves(ref_grad_norms: dict) -> list:
    med = statistics.median(ref_grad_norms.values())
    return sorted(k for k, g in ref_grad_norms.items() if g >= UNMOVED * med)


def leaf_gap(prog: dict, ref: dict, leaves) -> float:
    """The worst leaf's |norm gap| over max(its reference norm, the median
    leaf's reference norm)."""
    med = statistics.median(ref[k] for k in leaves)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in leaves)


def _first_gap(prog: dict, ref: dict, key: str) -> float:
    return abs(prog[key][0] - ref[key][0]) / abs(ref[key][0])


def _median_leaf_gap(prog: dict, ref: dict, leaves) -> float:
    med = statistics.median(ref[k] for k in leaves)
    return statistics.median(abs(prog[k] - ref[k]) / max(ref[k], med) for k in leaves)


def _diff_gap(prog: dict, ref: dict, ref_norms: dict, leaves) -> float:
    """The worst leaf's norm of the difference of the two first gradients,
    over the larger of the reference's norm of that leaf and of the median
    leaf: first order in the rounding, where a gap of norms is second."""
    med = statistics.median(ref_norms[k] for k in leaves)
    return max(float(torch.linalg.vector_norm((prog[k].double() - ref[k].double()))) / max(ref_norms[k], med)
               for k in leaves)


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: {"loss", "mse", "perceptual": [per step],
    "grad_norms", "change_norms": {leaf: norm}} -> the relative gaps of the
    first step's loss (``loss1_gap``), of its pixel and perceptual terms
    (``mse1_gap``, ``perc1_gap``) and of the worst step's loss
    (``loss_gap``); the first gradient's and the change's worst-leaf gaps
    (``grad_gap``, ``change_gap``) and median-leaf gaps
    (``grad_median_gap``, ``change_median_gap``); and the first gradient's
    worst-leaf difference (``grad_diff_gap``)."""
    if len(prog["loss"]) != len(ref["loss"]) or not prog["grad_norms"]:
        return {}
    leaves = counted_leaves(ref["grad_norms"])
    g, c = (prog["grad_norms"], ref["grad_norms"]), (prog["change_norms"], ref["change_norms"])
    return {
        "loss1_gap": _first_gap(prog, ref, "loss"),
        "mse1_gap": _first_gap(prog, ref, "mse"),
        "perc1_gap": _first_gap(prog, ref, "perceptual") if ref["perceptual"][0] else 0.0,
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])),
        "grad_gap": leaf_gap(*g, leaves),
        "grad_median_gap": _median_leaf_gap(*g, leaves),
        "grad_diff_gap": _diff_gap(prog["grads"], ref["grads"], ref["grad_norms"], leaves),
        "change_gap": leaf_gap(*c, leaves),
        "change_median_gap": _median_leaf_gap(*c, leaves),
    }


class _FakeFp8(torch.autograd.Function):
    """Round to float8 e4m3 under a per-tensor scale (amax / 448) and back;
    the gradient passes straight through."""

    @staticmethod
    def forward(ctx, t):
        scale = torch.clamp_min(t.detach().abs().amax(), 1e-30) / 448.0
        return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


def fp8_conv2d(x, w, b, padding=0, dilation=1):
    """The control's convolution: operands rounded to float8 e4m3 (the
    precision below bfloat16), products summed in float32."""
    return F.conv2d(_FakeFp8.apply(x), _FakeFp8.apply(w), b, padding=padding, dilation=dilation)
