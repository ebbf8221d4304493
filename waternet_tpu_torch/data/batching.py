"""The epoch shuffle and the host-side batch iterator.

Own copy of the JAX package's ``data/batching.py``: the same numpy Philox
stream, so the port composes every epoch's batches exactly as the JAX
trainer does, whether the batches come from the host or from a device
cache.
"""

from __future__ import annotations

from typing import Callable, Iterator, Tuple

import numpy as np


def epoch_permutation(indices, seed: int, epoch: int) -> np.ndarray:
    """Deterministic Philox shuffle of ``indices`` for (seed, epoch), key
    ``seed + 7919 * epoch``."""
    order = np.array(indices, copy=True)
    np.random.Generator(np.random.Philox(key=seed + 7919 * epoch)).shuffle(order)
    return order


def iter_batches(
    load_pair: Callable[[int], Tuple[np.ndarray, np.ndarray]],
    indices,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    epoch: int = 0,
    drop_remainder: bool = False,
    start: int = 0,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (raw_u8, ref_u8) NHWC uint8 batches for one epoch, in the
    order :func:`epoch_permutation` gives (or ``indices`` as given with
    ``shuffle=False``). ``start`` skips the first ``start`` batches
    without loading them (mid-epoch resume: the epoch's batches are the
    same, the iterator enters them at the recorded position)."""
    order = epoch_permutation(indices, seed, epoch) if shuffle else np.array(indices, copy=True)
    n = len(order)
    stop = n - n % batch_size if drop_remainder else n
    for s in range(start * batch_size, stop, batch_size):
        chunk = order[s : s + batch_size]
        raws, refs = zip(*(load_pair(int(i)) for i in chunk))
        yield np.stack(raws), np.stack(refs)
