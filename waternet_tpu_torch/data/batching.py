"""The epoch shuffle.

Own copy of the JAX package's ``data/batching.py::epoch_permutation``: the
same numpy Philox stream, so the port composes every epoch's batches
exactly as the JAX trainer does.
"""

from __future__ import annotations

import numpy as np


def epoch_permutation(indices, seed: int, epoch: int) -> np.ndarray:
    """Deterministic Philox shuffle of ``indices`` for (seed, epoch), key
    ``seed + 7919 * epoch``."""
    order = np.array(indices, copy=True)
    np.random.Generator(np.random.Philox(key=seed + 7919 * epoch)).shuffle(order)
    return order

