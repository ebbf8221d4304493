"""The dct8 device cache's round trip, written from its definition: each
8x8 block of ``pixels - 128`` (images edge-padded to multiples of 8) goes
through the orthonormal 8-point DCT-II on both axes, the 4x4
low-frequency corner is kept, divided by ``q[u, v] = 8 + 2 (u + v)``,
rounded and clipped to int8; decoding multiplies back, runs the inverse
transform over the kept corner, adds 128, rounds, clips and crops.

What the training cell's reference trains on: the pixels the cache
holds, worked out again from the raw images. Nothing here imports the
program under test.
"""

from __future__ import annotations

import numpy as np

ZONE = 4


def dct_basis() -> np.ndarray:
    """(8, 8) orthonormal DCT-II basis ``A``: ``coefficients = A @ x``."""
    k = np.arange(8, dtype=np.float64)
    a = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16.0) * np.sqrt(2.0 / 8.0)
    a[0] *= np.sqrt(0.5)
    return a


QUANT = np.array([[8.0 + 2.0 * (u + v) for v in range(ZONE)] for u in range(ZONE)])


def roundtrip(u8: np.ndarray) -> np.ndarray:
    """(N, H, W, C) uint8 -> the (N, H, W, C) uint8 pixels the cache decodes."""
    n, h, w, c = u8.shape
    ph, pw = (-h) % 8, (-w) % 8
    x = np.pad(u8, ((0, 0), (0, ph), (0, pw), (0, 0)), mode="edge").astype(np.float32) - np.float32(128.0)
    hp, wp = h + ph, w + pw
    blocks = x.reshape(n, hp // 8, 8, wp // 8, 8, c).transpose(0, 1, 3, 5, 2, 4)
    a = dct_basis().astype(np.float32)[:ZONE]
    coef = np.einsum("ux,vy,...xy->...uv", a, a, blocks) / QUANT.astype(np.float32)
    coef = np.clip(np.round(coef), -127, 127)
    pix = np.einsum("ux,vy,...uv->...xy", a.astype(np.float64), a.astype(np.float64), coef * QUANT)
    img = pix.transpose(0, 1, 4, 2, 5, 3).reshape(n, hp, wp, c)[:, :h, :w]
    return np.clip(np.round(img + 128.0), 0, 255).astype(np.uint8)
