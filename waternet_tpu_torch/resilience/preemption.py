"""Preemption handling: turn SIGTERM/SIGINT into a clean checkpoint.

The JAX package's ``resilience/preemption.py``, lifted. Preemptible/spot
cloud VMs get SIGTERM with a ~30 s grace window; a
400-epoch run that dies mid-epoch without one loses up to an epoch of work
*and* its exact dataloader position. :class:`PreemptionGuard` installs
handlers that only set a flag; the trainer's epoch driver checks the flag at
every step boundary and raises :class:`Preempted` carrying the position
``(next_batch, partial per-step metrics)``, which train.py turns into a
mid-epoch checkpoint. Because batch composition is a pure function of
``(seed, epoch)`` (the shared Philox stream in
:func:`waternet_tpu_torch.data.batching.epoch_permutation`), resuming from that
position replays the interrupted epoch bit-for-bit.

Multi-host: the flag is process-local. GCE delivers the preemption signal to
every VM in the slice, so all processes reach the same boundary and the
checkpoint save stays collective; delivering a manual SIGTERM to a single
process of a multi-process job would desynchronize the fleet (documented in
docs/RESILIENCE.md).
"""

from __future__ import annotations

import signal


class Preempted(Exception):
    """Raised by the epoch driver at the first step boundary after a signal.

    ``next_batch`` is the epoch-relative index of the first batch NOT yet
    trained; ``partial`` is the ordered list of per-step metric dicts (host
    floats) for the batches that did complete — exactly the carry a resumed
    epoch needs to reproduce the uninterrupted epoch means bit-for-bit.
    """

    def __init__(self, next_batch: int, partial: list):
        super().__init__(f"preempted before batch {next_batch}")
        self.next_batch = next_batch
        self.partial = partial


class PreemptionGuard:
    """Context manager: latch SIGTERM/SIGINT into a ``requested`` flag.

    The handler does no I/O and no device calls (it runs at an arbitrary
    bytecode boundary); all real work happens at the next step boundary in
    the training loop. A second signal restores the previous disposition and
    re-raises it, so a stuck run can still be killed.
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.signals = tuple(signals)
        self.requested = False
        self._previous: dict = {}

    def _handle(self, signum, frame):
        if self.requested:
            # Second signal: the operator means it. Restore and re-deliver.
            self._restore()
            signal.raise_signal(signum)
            return
        self.requested = True

    def __enter__(self):
        for s in self.signals:
            self._previous[s] = signal.signal(s, self._handle)
        return self

    def _restore(self):
        for s, prev in self._previous.items():
            signal.signal(s, prev)
        self._previous = {}

    def __exit__(self, *exc):
        self._restore()
        return False
