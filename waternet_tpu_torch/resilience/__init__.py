"""Fault tolerance for long training runs: the JAX package's
``resilience/`` package, lifted, over the port's torch state.

At the reference's 400-epoch horizon, a preempted VM, a corrupt input or
a NaN step is the likely way to lose a run. The pieces the port's
``train.py`` wires through the trainer, the checkpoint layer and the data
pipelines:

* :mod:`preemption` — SIGTERM/SIGINT -> checkpoint at the next step
  boundary (:class:`PreemptionGuard`, :class:`Preempted`);
* :mod:`manager` — atomic, marker-finalized checkpoints with retention
  and validated ``--resume auto`` fallback (:class:`CheckpointManager`,
  :func:`auto_resume`);
* :mod:`sentinel` — non-finite loss detection with rollback to a
  last-good snapshot and bounded batch-skip (:class:`DivergenceSentinel`);
* :mod:`control` — the per-epoch bundle the trainer's epoch driver
  consults at step boundaries (:class:`EpochControl`);
* :mod:`faults` — the deterministic fault-injection harness
  (``WATERNET_FAULTS`` or programmatic plans), parsing the same specs as
  the JAX package's;
* :mod:`heartbeat` — step-boundary liveness records and the per-worker
  health state machine (:class:`HeartbeatWriter`, :class:`WorkerHealth`);
* :mod:`supervisor` — the gang supervisor of multi-process training
  (``python -m waternet_tpu_torch.resilience.supervisor``): spawns the
  workers with the ``WATERNET_*`` env contract, restarts the gang from
  the last complete checkpoint after a crash or a hang.
"""

from waternet_tpu_torch.resilience.control import EpochControl
from waternet_tpu_torch.resilience.heartbeat import HeartbeatWriter, WorkerHealth
from waternet_tpu_torch.resilience.manager import CheckpointManager, auto_resume
from waternet_tpu_torch.resilience.preemption import Preempted, PreemptionGuard
from waternet_tpu_torch.resilience.sentinel import DivergenceError, DivergenceSentinel

__all__ = [
    "CheckpointManager",
    "DivergenceError",
    "DivergenceSentinel",
    "EpochControl",
    "HeartbeatWriter",
    "Preempted",
    "PreemptionGuard",
    "WorkerHealth",
    "auto_resume",
]
