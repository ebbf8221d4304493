"""UIEB paired dataset, its reference split, and the host batch iterator.

The port of the JAX package's ``data/uieb.py``:

* pairs ``*.png`` files by name across a raw and a reference directory
  (the names must match);
* resizes to (width, height), or to the nearest multiple of 32 below
  each side when no size is given;
* BGR -> RGB, and a uint8 RAM cache: every pair is decoded once;
* :func:`reference_split` reproduces the reference's torch seed-0
  ``random_split(dataset, [800, 90])``: a static permutation for the
  canonical 890 pairs, torch's own ``randperm`` stream otherwise;
* a pair whose PNG does not decode after retries raises
  :class:`CorruptPairError` and is quarantined; :meth:`UIEBDataset.
  prevalidate` strips such pairs from an index set up front.

``cv2`` is imported where a file is decoded, not when this module is.
"""

from __future__ import annotations

import warnings
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from waternet_tpu_torch.data.batching import iter_batches


class CorruptPairError(RuntimeError):
    """A pair's raw or reference PNG failed to decode after retries; names
    the pair and the offending file."""

    def __init__(self, name: str, path):
        super().__init__(f"could not decode {path} (pair {name!r})")
        self.name = name
        self.path = path


def reference_split(n_total: int, n_val: int = 90, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(train_indices, val_indices), matching torch's seed-``seed``
    ``random_split``: the first ``n_total - n_val`` entries of the
    permutation train, the rest validate."""
    if n_total == 890 and seed == 0:
        from waternet_tpu_torch.data._split_constants import TORCH_SEED0_PERM_890

        perm = np.asarray(TORCH_SEED0_PERM_890, dtype=np.int64)
    else:
        g = torch.Generator()
        g.manual_seed(seed)
        perm = torch.randperm(n_total, generator=g).numpy()
    n_train = n_total - n_val
    return perm[:n_train], perm[n_train:]


class UIEBDataset:
    """Paired underwater image dataset with a uint8 RAM cache."""

    def __init__(
        self,
        raw_dir,
        ref_dir,
        im_height: Optional[int] = None,
        im_width: Optional[int] = None,
        cache: bool = True,
    ):
        self.raw_dir = Path(raw_dir)
        self.ref_dir = Path(ref_dir)
        raw_names = sorted(p.name for p in self.raw_dir.glob("*.png"))
        ref_names = sorted(p.name for p in self.ref_dir.glob("*.png"))
        if set(raw_names) != set(ref_names):
            raise ValueError(
                f"raw/ref filename mismatch: {len(raw_names)} raw vs {len(ref_names)} ref pngs"
            )
        self.names = raw_names
        self.im_height = im_height
        self.im_width = im_width
        self._cache: Optional[dict] = {} if cache else None
        # Pair names whose PNGs failed to decode (see load_pair/prevalidate).
        self.quarantined: list[str] = []

    def __len__(self) -> int:
        return len(self.names)

    def _target_size(self, shape) -> Tuple[int, int]:
        if self.im_width is not None and self.im_height is not None:
            return self.im_width, self.im_height
        h, w = shape[0], shape[1]
        return (w // 32) * 32, (h // 32) * 32

    @staticmethod
    def _imread_retry(path, retries: int = 2):
        """Decode with retries (transient I/O on network volumes); None on
        persistent failure, as ``cv2.imread`` returns for a corrupt file.

        Runs wherever ``load_pair`` runs, pipeline worker threads included,
        so the ``decode@K`` fault hook lives here: an injected failure
        consumes one attempt, as a real transient error does."""
        import cv2

        from waternet_tpu_torch.resilience import faults

        for _ in range(1 + retries):
            if faults.imread_should_fail():
                continue  # injected decode failure: one attempt consumed
            img = cv2.imread(str(path))
            if img is not None:
                return img
        return None

    def load_pair(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """-> (raw_rgb_u8, ref_rgb_u8), resized, cached. Raises
        :class:`CorruptPairError` (and quarantines the pair's name) when
        either side fails to decode after retries."""
        if self._cache is not None and idx in self._cache:
            return self._cache[idx]
        import cv2

        name = self.names[idx]
        raw = self._imread_retry(self.raw_dir / name)
        ref = self._imread_retry(self.ref_dir / name)
        if raw is None or ref is None:
            if name not in self.quarantined:
                self.quarantined.append(name)
            bad_path = (self.raw_dir if raw is None else self.ref_dir) / name
            raise CorruptPairError(name, bad_path)
        tw, th = self._target_size(raw.shape)
        raw = cv2.cvtColor(cv2.resize(raw, (tw, th)), cv2.COLOR_BGR2RGB)
        ref = cv2.cvtColor(cv2.resize(ref, (tw, th)), cv2.COLOR_BGR2RGB)
        pair = (raw, ref)
        if self._cache is not None:
            self._cache[idx] = pair
        return pair

    def prevalidate(self, indices) -> np.ndarray:
        """Decode every pair of ``indices`` once; return the clean subset.

        Corrupt pairs are excluded before batch composition is fixed, with
        a warning naming each; an index set with no clean pair raises."""
        bad = []
        for i in indices:
            try:
                self.load_pair(int(i))
            except CorruptPairError as e:
                bad.append((int(i), e.name))
        if not bad:
            return np.asarray(indices)
        if len(bad) == len(indices):
            raise ValueError(
                f"all {len(bad)} pairs failed to decode — dataset unusable (first: {bad[0][1]!r})"
            )
        names = ", ".join(name for _, name in bad)
        warnings.warn(
            f"quarantined {len(bad)}/{len(indices)} corrupt pair(s): {names}. "
            "They are excluded from this run; re-fetch the files to restore them.",
            RuntimeWarning,
            stacklevel=2,
        )
        bad_idx = {i for i, _ in bad}
        return np.asarray([int(i) for i in indices if int(i) not in bad_idx])

    def batches(self, indices, batch_size: int, **kwargs) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (raw_u8, ref_u8) NHWC uint8 batches for one epoch
        (see :func:`waternet_tpu_torch.data.batching.iter_batches`)."""
        return iter_batches(self.load_pair, indices, batch_size, **kwargs)
