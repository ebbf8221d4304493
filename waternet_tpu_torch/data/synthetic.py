"""Procedural paired data: "underwater raw / enhanced reference" uint8 pairs.

Own copy of the JAX package's ``data/synthetic.py``, numpy only, so a
pair is byte-identical in both packages for the same (index, seed). The
reference is a colourful procedural texture; the raw image is the same
texture with a blue-green cast and channel-dependent attenuation.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from waternet_tpu_torch.data.batching import iter_batches


class SyntheticPairs:
    def __init__(self, n: int, im_height: int, im_width: int, seed: int = 0):
        self.n = n
        self.h = im_height
        self.w = im_width
        self.seed = seed
        self._cache: dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    def __len__(self) -> int:
        return self.n

    def load_pair(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        if idx in self._cache:
            return self._cache[idx]
        rng = np.random.default_rng(self.seed * 1_000_003 + idx)
        h, w = self.h, self.w
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        ref = np.zeros((h, w, 3), np.float32)
        for c in range(3):
            fx, fy = rng.uniform(0.02, 0.3, 2)
            px, py = rng.uniform(0, 6.3, 2)
            amp = rng.uniform(40, 90)
            base = rng.uniform(60, 180)
            ref[:, :, c] = base + amp * np.sin(fx * xx + px) * np.cos(fy * yy + py)
        ref += rng.normal(0, 6, ref.shape)
        ref = np.clip(ref, 0, 255)

        # Underwater degradation: strong red attenuation, green/blue cast.
        atten = np.array([0.35, 0.75, 0.9], np.float32)
        cast = np.array([5.0, 25.0, 35.0], np.float32)
        depth = rng.uniform(0.6, 1.0)
        raw = ref * (atten**depth) + cast * depth
        raw = np.clip(raw + rng.normal(0, 4, raw.shape), 0, 255)

        pair = (raw.astype(np.uint8), ref.astype(np.uint8))
        self._cache[idx] = pair
        return pair

    def batches(self, indices, batch_size: int, **kwargs) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (raw_u8, ref_u8) batches for one epoch (see
        :func:`waternet_tpu_torch.data.batching.iter_batches`)."""
        return iter_batches(self.load_pair, indices, batch_size, **kwargs)


def synthetic_split(n: int, val_size: int = 90):
    """(train_idx, val_idx): the LAST ``max(1, min(val_size, n // 8))``
    indices are val, contiguous, as in the JAX package."""
    n_val = max(1, min(val_size, n // 8))
    idx = np.arange(n)
    return idx[:-n_val], idx[-n_val:]
