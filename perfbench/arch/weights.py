"""Seeded weights, made on the device in one draw."""

from __future__ import annotations

import math

import torch


def uniform_leaves(leaves, gen: torch.Generator, device) -> dict:
    """``leaves``: [(name, shape, fan_in, kind)], kind "weight" or "bias".
    One uniform draw on ``device`` for all of them, each leaf a slice of
    it scaled to He's uniform bound ``sqrt(6 / fan_in)`` (weights) or
    ``1 / sqrt(fan_in)`` (biases): float32, the type they are served in."""
    sizes = [math.prod(shape) for _, shape, _, _ in leaves]
    flat = torch.rand(sum(sizes), generator=gen, device=device, dtype=torch.float32).mul_(2.0).sub_(1.0)
    out, start = {}, 0
    for (name, shape, fan_in, kind), size in zip(leaves, sizes):
        bound = math.sqrt(6.0 / fan_in) if kind == "weight" else 1.0 / math.sqrt(fan_in)
        out[name] = flat[start:start + size].view(shape).mul_(bound)
        start += size
    return out


def conv_leaves(prefix: str, cin: int, cout: int, k: int) -> list:
    fan_in = cin * k * k
    return [(f"{prefix}.weight", (cout, cin, k, k), fan_in, "weight"), (f"{prefix}.bias", (cout,), fan_in, "bias")]
