"""Per-epoch resilience bundle consulted by the trainer's epoch driver.

The JAX package's ``resilience/control.py``, lifted.

One object instead of four keyword arguments: the driver asks it (a) has a
preemption been requested, (b) is a divergence sentinel active, (c) is a
mid-epoch checkpoint due. train.py builds one per epoch with a checkpoint
callback that closes over the run's CheckpointManager and metric history.

Checkpoint cadence: ``every_steps`` counts dispatched steps (deterministic
across hosts); ``every_secs`` uses the
host monotonic clock, which is NOT synchronized across hosts, so train.py
refuses time-based cadence for multi-process runs (see docs/RESILIENCE.md).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from waternet_tpu_torch.resilience.preemption import PreemptionGuard
from waternet_tpu_torch.resilience.sentinel import DivergenceSentinel


@dataclasses.dataclass
class EpochControl:
    preemption: Optional[PreemptionGuard] = None
    sentinel: Optional[DivergenceSentinel] = None
    # checkpoint_cb(next_batch, partial_step_metrics) — set by train.py to
    # CheckpointManager.save with the epoch's position + metric carry.
    checkpoint_cb: Optional[Callable[[int, list], None]] = None
    every_steps: int = 0
    every_secs: float = 0.0
    # Supervision liveness (docs/RESILIENCE.md "Multi-process
    # supervision"): a HeartbeatWriter the driver ticks once per
    # dispatched step — pure host work riding the deferred-metrics loop
    # (no device fetch), throttled inside the writer.
    heartbeat: Optional[object] = None
    _steps_since_ckpt: int = 0
    _last_ckpt_time: float = dataclasses.field(default_factory=time.monotonic)

    def preempt_requested(self) -> bool:
        return self.preemption is not None and self.preemption.requested

    def checkpoint_due(self) -> bool:
        """Called once per completed step; latches the interval cadence."""
        if self.checkpoint_cb is None:
            return False
        self._steps_since_ckpt += 1
        if self.every_steps and self._steps_since_ckpt >= self.every_steps:
            return True
        if self.every_secs and (
            time.monotonic() - self._last_ckpt_time >= self.every_secs
        ):
            return True
        return False

    def checkpoint(self, next_batch: int, partial: list) -> None:
        self.checkpoint_cb(next_batch, partial)
        self._steps_since_ckpt = 0
        self._last_ckpt_time = time.monotonic()
