"""Divergence sentinel: bounded NaN/Inf containment for the train loop.

The JAX package's ``resilience/sentinel.py``, lifted.

A single non-finite loss step poisons params *and* Adam moments, and with
the repo's deferred-metrics fetch (metrics are pulled once per epoch) an
unguarded run can burn a whole epoch of device time training garbage. The
sentinel folds finite checks into that deferred fetch: the epoch driver
verifies pending metrics every ``window`` steps (keeping the async pipeline
``window`` deep instead of fully epoch-deep), and on the first non-finite
value rolls the engine back to the snapshot taken at the last verified
boundary, replays the verified-good prefix (bit-identical — batches, rng
generators, and augment draws are pure functions of (seed, epoch, batch index)),
skips the offending batch, and re-runs the tail. Skips are bounded:
exceeding ``max_skips`` in one epoch raises :class:`DivergenceError`
because at that point the run is diverging, not hitting a stray batch.

Multi-host: decisions are made from replicated metric values, so every
process computes the same first-bad index and takes the same rollback path.
"""

from __future__ import annotations

import dataclasses


class DivergenceError(RuntimeError):
    """Too many non-finite steps in one epoch: the run is diverging."""


@dataclasses.dataclass
class DivergenceSentinel:
    """Counters + policy; the replay mechanics live in the epoch driver."""

    window: int = 16  # steps between deferred finite checks (pipeline depth)
    max_skips: int = 8  # per-epoch skip budget before declaring divergence
    skipped: int = 0
    rollbacks: int = 0

    def begin_epoch(self) -> None:
        self.skipped = 0
        self.rollbacks = 0

    def note_skip(self, batch_index: int) -> None:
        self.rollbacks += 1
        self.skipped += 1
        if self.skipped > self.max_skips:
            raise DivergenceError(
                f"skipped {self.skipped} non-finite steps this epoch "
                f"(budget {self.max_skips}); last at batch {batch_index}. "
                "The run is diverging — lower the LR or inspect the data."
            )

    @staticmethod
    def first_bad(values: list) -> int | None:
        """Index of the first per-step metrics dict with a non-finite value."""
        import math

        for i, m in enumerate(values):
            if any(not math.isfinite(v) for v in m.values()):
                return i
        return None
