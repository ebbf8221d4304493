"""Seeded photo-like frames for the card runs (no dataset needed)."""

from __future__ import annotations

import numpy as np


def photo_frames(rng: np.random.Generator, n: int, h: int, w: int) -> np.ndarray:
    """(n, h, w, 3) uint8: per channel, a smooth sinusoid field at random
    frequencies and phases plus Gaussian noise, so white balance and CLAHE
    see photo-like histograms."""
    yy = np.arange(h, dtype=np.float32)[:, None]
    xx = np.arange(w, dtype=np.float32)[None, :]
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        for c in range(3):
            fy, fx = rng.uniform(0.004, 0.03, 2)
            py, px = rng.uniform(0.0, 6.3, 2)
            base = 50 + 55 * c + 45 * np.sin(xx * fx + px) + 35 * np.cos(yy * fy + py)
            noise = rng.normal(0.0, 10.0, (h, w)).astype(np.float32)
            out[i, :, :, c] = np.clip(base + noise, 0, 255).astype(np.uint8)
    return out
