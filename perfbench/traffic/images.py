"""Photo-like uint8 frames and training pairs, made on the device from a
seeded generator in a few large calls.

A reference image is a smooth colour texture per channel (a base level
plus a product of a sine across and a cosine down, with their own
frequencies and phases) and grain; its raw underwater view attenuates red
most and blue least, adds a blue-green cast and sensor noise.
"""

from __future__ import annotations

import torch

_ATTEN = (0.35, 0.75, 0.9)
_CAST = (5.0, 25.0, 35.0)


def pairs(gen: torch.Generator, n: int, h: int, w: int, device, chunk: int = 32):
    """(raw, ref): two (n, h, w, 3) uint8 tensors on ``device``."""
    u = torch.rand((n, 3, 6), generator=gen, device=device)
    fx, fy = 0.02 + 0.28 * u[..., 0], 0.02 + 0.28 * u[..., 1]
    px, py = 6.3 * u[..., 2], 6.3 * u[..., 3]
    amp, base = 40.0 + 50.0 * u[..., 4], 60.0 + 120.0 * u[..., 5]
    depth = 0.6 + 0.4 * torch.rand((n, 1, 1, 1), generator=gen, device=device)
    atten = torch.tensor(_ATTEN, device=device)
    cast = torch.tensor(_CAST, device=device)
    yy = torch.arange(h, device=device, dtype=torch.float32).view(1, h, 1, 1)
    xx = torch.arange(w, device=device, dtype=torch.float32).view(1, 1, w, 1)
    raw = torch.empty((n, h, w, 3), dtype=torch.uint8, device=device)
    ref = torch.empty_like(raw)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)

        def per(t):
            return t[s:e].view(e - s, 1, 1, 3)

        tex = per(base) + per(amp) * torch.sin(per(fx) * xx + per(px)) * torch.cos(per(fy) * yy + per(py))
        r = torch.clamp(tex + 6.0 * torch.randn(tex.shape, generator=gen, device=device), 0.0, 255.0)
        d = depth[s:e]
        v = r * torch.pow(atten, d) + cast * d + 4.0 * torch.randn(tex.shape, generator=gen, device=device)
        ref[s:e] = r.to(torch.uint8)
        raw[s:e] = torch.clamp(v, 0.0, 255.0).to(torch.uint8)
    return raw, ref


def frames(gen: torch.Generator, n: int, h: int, w: int, device):
    """(n, h, w, 3) uint8 raw frames on ``device``."""
    return pairs(gen, n, h, w, device, chunk=8)[0]
