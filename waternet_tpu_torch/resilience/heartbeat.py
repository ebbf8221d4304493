"""Worker heartbeats + the per-worker health state machine.

The JAX package's ``resilience/heartbeat.py``, lifted: records keep its
keys, and ``process_id`` is 0 until multi-GPU training (ROADMAP Queue A
item 8) brings more processes and the port's supervisor. A supervisor
(the JAX package's ``resilience/supervisor.py``) cannot tell a
worker that is *computing* from one that is *wedged* by looking at the
process table — both are alive. The trainer therefore emits a tiny
heartbeat record at step boundaries (:class:`HeartbeatWriter`, wired
through :class:`waternet_tpu_torch.resilience.control.EpochControl`), and the
supervisor drives a per-worker state machine off record freshness
(:class:`WorkerHealth`):

    starting -> running -> late -> presumed-hung
                 \\------------------> dead / done   (process exited)

Design constraints, in order:

* **Step time unchanged.** A beat is a single ``time.monotonic()``
  comparison on the hot path; at most once per ``min_interval_sec`` it
  writes ~200 bytes via tmp + ``os.replace``. No device interaction at
  all — emission rides the trainer's deferred-metrics loop *without*
  fetching anything, so the step's asynchronous dispatch is untouched.
* **Torn reads impossible.** ``os.replace`` makes each record atomic;
  readers (:func:`read_heartbeat`) additionally tolerate records that are
  missing, vanishing, or truncated mid-swap and simply report ``None``.
* **Restart-generation aware.** Every record carries the generation so a
  supervisor never mistakes a stale gen-N file for gen-N+1 progress; the
  supervisor also points each generation at a fresh directory.

The state machine is pure — ``observe(now, ...)`` takes explicit
timestamps — so thresholds, budgets, and transitions are unit-testable
with no processes and no sleeping (tests/test_supervisor.py).
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Optional

#: Supervisor -> worker contract: directory heartbeat records go in.
ENV_HEARTBEAT_DIR = "WATERNET_HEARTBEAT_DIR"
#: Emission throttle (seconds between records; beats inside the window are
#: a no-op comparison).
ENV_HEARTBEAT_SEC = "WATERNET_HEARTBEAT_SEC"
#: Fleet-router -> serving-worker identity contract
#: (the JAX package's serving/fleet.py): the slot index and restart generation a
#: worker writes into its heartbeat records, and the opaque worker id it
#: stamps on every response as ``X-Worker-Id`` so client ledgers can
#: split accounting by the worker that actually served.
ENV_WORKER_SLOT = "WATERNET_WORKER_SLOT"
ENV_WORKER_GENERATION = "WATERNET_WORKER_GENERATION"
ENV_WORKER_ID = "WATERNET_WORKER_ID"

# Health states (str, not enum: they go straight into JSON reports).
STARTING = "starting"  # launched, no heartbeat yet (compile / data warmup)
RUNNING = "running"
LATE = "late"  # no beat for late_sec: worth logging, not yet actionable
HUNG = "presumed-hung"  # no beat for hang_sec: treated as failed
DEAD = "dead"  # process exited nonzero (or exited while work remained)
DONE = "done"  # process exited 0


def heartbeat_path(directory, process_id: int) -> Path:
    return Path(directory) / f"worker-{int(process_id):03d}.json"


class HeartbeatWriter:
    """Throttled atomic heartbeat records for one worker process."""

    def __init__(
        self,
        path,
        min_interval_sec: float = 1.0,
        process_id: int = 0,
        generation: int = 0,
    ):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.min_interval_sec = float(min_interval_sec)
        self.process_id = int(process_id)
        self.generation = int(generation)
        self.epoch: Optional[int] = None  # stamped per epoch by train.py
        self._seq = 0
        self._last_mono = float("-inf")

    @classmethod
    def resolve(
        cls, directory=None, process_id: int = 0, generation: int = 0
    ) -> "HeartbeatWriter | None":
        """Build a writer from an explicit ``--heartbeat-dir`` or the
        supervisor's env contract; ``None`` (no heartbeating) when neither
        names a directory."""
        directory = directory or os.environ.get(ENV_HEARTBEAT_DIR)
        if not directory:
            return None
        interval = float(os.environ.get(ENV_HEARTBEAT_SEC, "1.0"))
        return cls(
            heartbeat_path(directory, process_id),
            min_interval_sec=interval,
            process_id=process_id,
            generation=generation,
        )

    def beat(self, step: int = 0, phase: str = "train", force: bool = False) -> bool:
        """Emit a record unless one was written < min_interval_sec ago.

        Hot-path cost when throttled: one monotonic read + compare. Returns
        whether a record was written (tests assert the throttle).
        """
        now = time.monotonic()
        if not force and now - self._last_mono < self.min_interval_sec:
            return False
        self._last_mono = now
        self._seq += 1
        record = {
            "pid": os.getpid(),
            "process_id": self.process_id,
            "generation": self.generation,
            "seq": self._seq,
            "step": int(step),
            "epoch": self.epoch,
            "phase": phase,
            "time": time.time(),
        }
        tmp = self.path.with_name(self.path.name + ".tmp")
        tmp.write_text(json.dumps(record))
        os.replace(tmp, self.path)
        return True


def read_heartbeat(path) -> Optional[dict]:
    """Latest record at ``path``, or None (missing / mid-swap / torn)."""
    try:
        return json.loads(Path(path).read_text())
    except (OSError, json.JSONDecodeError, ValueError):
        return None


class WorkerHealth:
    """Freshness-driven health state machine for one worker.

    Pure: every input (wall-clock ``now``, last heartbeat time, exit code)
    is an explicit argument to :meth:`observe`, so every transition is
    unit-testable without processes or sleeps. The supervisor feeds it
    ``record["time"]`` from :func:`read_heartbeat` (same machine, same
    clock) and ``Popen.poll()``.

    A worker that exits is terminal (``done``/``dead``) regardless of
    heartbeat age. Until the first *live-phase* beat (``live_phase``,
    default ``"train"`` for trainer gangs, ``"serve"`` under the fleet
    router), only ``startup_grace_sec`` (measured from launch) can
    declare a hang —
    that window legitimately holds the framework import, the coordinator join,
    checkpoint restore, and the cold compile, announced only by
    startup-phase beats. From the first train beat on, record freshness
    drives ``running -> late -> presumed-hung`` via ``late_sec`` /
    ``hang_sec``. ``late`` is an observability state only: the
    supervisor logs it but acts solely on ``presumed-hung`` / ``dead``.
    """

    def __init__(
        self,
        late_sec: float,
        hang_sec: float,
        startup_grace_sec: float,
        started_at: float,
        live_phase: str = "train",
    ):
        if not late_sec <= hang_sec:
            raise ValueError(f"late_sec {late_sec} must be <= hang_sec {hang_sec}")
        self.late_sec = float(late_sec)
        self.hang_sec = float(hang_sec)
        self.startup_grace_sec = float(startup_grace_sec)
        self.started_at = float(started_at)
        # Which beat phase proves the worker reached steady state: "train"
        # for trainer gangs (the original machine), "serve" for the fleet
        # router's serving workers. Until the first live-phase beat, only
        # the startup grace can declare a hang — same reasoning, different
        # warmup (AOT compile + bucket warm instead of restore + step one).
        self.live_phase = str(live_phase)
        self.state = STARTING
        self.last_beat: Optional[float] = None
        self.first_step: Optional[int] = None
        self.last_step: Optional[int] = None
        self.exit_code: Optional[int] = None

    def note_beat(self, record: dict) -> None:
        """Fold a heartbeat record in (before calling :meth:`observe`)."""
        t = float(record.get("time", 0.0))
        if self.last_beat is None or t > self.last_beat:
            self.last_beat = t
            step = int(record.get("step", 0))
            # first_step anchors "where this generation resumed": the first
            # *live-phase* beat carries the first post-warmup step, while
            # the startup beat is step 0 by construction and would pollute
            # it.
            if self.first_step is None and record.get("phase") == self.live_phase:
                self.first_step = step
            if self.last_step is None or step > self.last_step:
                self.last_step = step

    def observe(self, now: float, exit_code: Optional[int] = None) -> str:
        """Advance the state machine; returns the (possibly new) state."""
        if self.state in (DONE, DEAD):
            return self.state  # terminal
        if exit_code is not None:
            self.exit_code = int(exit_code)
            self.state = DONE if exit_code == 0 else DEAD
            return self.state
        if self.last_beat is None or self.first_step is None:
            # Between launch and the first *train-step* beat sit the framework
            # import, the coordinator join, checkpoint restore, and the
            # cold train-step compile — with only startup-phase beats in
            # between. Only the startup grace bounds this window: arming
            # hang_sec off the startup beat false-triggers on any compile
            # or restore longer than a few step times (observed as a
            # resumed generation "hanging" mid-restore, the supervisor
            # then draining perfectly healthy workers).
            if now - self.started_at >= self.startup_grace_sec:
                self.state = HUNG
            return self.state
        age = now - self.last_beat
        if age >= self.hang_sec:
            self.state = HUNG
        elif age >= self.late_sec:
            self.state = LATE
        else:
            self.state = RUNNING
        return self.state

    @property
    def failed(self) -> bool:
        return self.state in (HUNG, DEAD)

    def summary(self) -> dict:
        return {
            "state": self.state,
            "exit_code": self.exit_code,
            "first_step": self.first_step,
            "last_step": self.last_step,
        }
