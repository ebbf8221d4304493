"""Deterministic fault injection for the resilience test suite.

The JAX package's ``resilience/faults.py``, lifted whole so that a
``WATERNET_FAULTS`` spec parses to the same events in both packages; only
the ``nan`` hook touches the model, here torch parameters. The port's
serving layer (``waternet_tpu_torch/serving/``) calls the replica and
front-door hooks (``slow_replica``, ``replica_crash``, ``replica_hang``,
``nan_output``, ``reject_admit``, ``gateway_crash``, ``gateway_hang``),
the stream sessions (``serving/streams.py``) the stream kinds, and the
train CLI's workers ``proc_kill``/``proc_hang``, which the gang
supervisor (``resilience/supervisor.py``) reaps; the module paths named
below are the JAX package's.

Real preemptions, NaN steps, and corrupt files are rare and nondeterministic;
this harness makes each one a reproducible event so tests (and operators
doing fire drills) can assert exact recovery behavior. A :class:`FaultPlan`
is a set of one-shot events, each keyed by a deterministic counter:

* ``nan@K`` — after the engine dispatches global step K (1-based, counted on
  the host), poison the train state's float params with NaN and report a
  NaN loss for that step: the faithful signature of a non-finite gradient.
* ``sigterm@K`` — deliver a real SIGTERM to this process after global step
  K, exercising the actual signal path of
  :class:`waternet_tpu_torch.resilience.preemption.PreemptionGuard`.
* ``proc_kill@K`` — the process self-terminates HARD (SIGKILL to itself)
  after global step K: no drain, no checkpoint, no atexit — the faithful
  signature of an OOM kill or an unannounced VM preemption. The training
  supervisor (docs/RESILIENCE.md "Multi-process supervision") must detect
  the exit and restart the gang from the last complete checkpoint.
* ``proc_hang@K`` — the process wedges after global step K *without
  heartbeating*: the dispatch thread blocks on a release latch, so step
  progress and heartbeat emission both stop while the process stays
  alive — the faithful signature of a stuck collective or a wedged
  device. The supervisor must detect this by heartbeat timeout (never by
  waiting on the collective). Releasable like ``replica_hang``: the
  wedged thread wakes on :func:`clear` / :func:`install`, so in-process
  tests stay joinable; under the supervisor nothing clears the plan and
  the worker is SIGKILLed after the drain grace.
* ``truncate_ckpt@K`` — after the K-th (1-based) finalized checkpoint save,
  truncate its largest payload file, simulating a mid-write crash or torn
  volume that the marker protocol alone cannot see.
* ``decode@K`` — the K-th ``cv2.imread`` *attempt* (1-based, process-global,
  counted across pipeline worker threads under a lock) reports a decode
  failure, exercising :meth:`UIEBDataset._imread_retry`'s retry path — and,
  when enough consecutive attempts are armed to exhaust the retries, the
  quarantine path — exactly where production hits them: inside the input
  pipeline's workers.
* ``slow_replica@K`` — the K-th bucketed batch *launch* (1-based,
  process-global across every replica's launch thread, under a lock)
  sleeps ``WATERNET_FAULT_SLOW_SEC`` (default 0.25) before dispatching,
  simulating a replica whose device stalls mid-serve — the deterministic
  way to hold work in flight so drain, deadline-expiry, and shed paths
  are testable (serving/replicas.py calls :func:`replica_launch_fault`).
* ``replica_crash@K`` — the K-th bucketed batch launch raises, the
  faithful signature of a replica whose XLA dispatch dies mid-serve.
  The supervised pool (docs/SERVING.md "Fault isolation") must contain
  it: the batch's requests re-dispatch onto surviving replicas and the
  sick replica walks the quarantine → re-warm → reintegrate machine.
* ``replica_hang@K`` — the K-th bucketed batch launch blocks
  indefinitely (a wedged driver / stalled device), releasable: the
  wedged thread wakes when the plan is cleared or replaced
  (:func:`clear` / :func:`install`), so tests can assert the watchdog
  path and still join every thread. Until release, the launch neither
  completes nor raises — exactly what a watchdog exists to catch.
* ``nan_output@K`` — the K-th *completed* serving batch's host array is
  poisoned after D2H (float outputs → NaN, uint8 outputs → an all-zero
  canvas), exercising the replica pool's output sanity guard
  (serving/replicas.py calls :func:`poison_replica_output`).
* ``reject_admit@K`` — the K-th admission attempt at the HTTP front door
  (1-based, process-global) is force-shed with 429 regardless of queue
  depth, exercising the shed path and client retry behavior without
  having to actually saturate the queue
  (serving/server.py calls :func:`admit_should_reject`).
* ``stream_stall@K`` — the K-th stream session opened on the front door
  (1-based, process-global) behaves as a wedged consumer: every record
  delivery to that session sleeps ``WATERNET_FAULT_STALL_SEC`` (default
  0.25) before the write, the faithful signature of a client that
  stopped reading — the deterministic way to prove a stalled stream
  backpressures only itself (serving/streams.py calls
  :func:`stream_session_fault` at session open).
* ``stream_disconnect@K`` — the K-th stream session opened is
  force-disconnected server-side after reading
  ``WATERNET_FAULT_DISCONNECT_FRAMES`` (default 2) frames, simulating a
  client that vanished mid-stream with frames still queued — the
  cancellation/cleanup path without real socket timing races.
* ``frame_corrupt@K`` — the K-th stream frame decode attempt (1-based,
  process-global across sessions, under a lock) is treated as
  undecodable, exercising the per-frame quarantine path: that frame
  alone errors, its session and every other stream keep flowing
  (serving/streams.py calls :func:`frame_should_corrupt`).
* ``gateway_crash@K`` — the K-th ``/enhance`` arrival at THIS serving
  process (1-based, per-process) self-terminates it HARD (SIGKILL, no
  drain): the faithful signature of a serving worker OOM-killed with a
  request in flight. The fleet router (docs/SERVING.md "Fleet") must
  detect the exit, re-dispatch the in-flight request onto a surviving
  worker, and relaunch the gateway as a fresh generation
  (serving/server.py calls :func:`gateway_fault`).
* ``gateway_hang@K`` — the K-th ``/enhance`` arrival wedges the serving
  process's event loop on a release latch: ``/healthz`` stops
  answering, heartbeats stop, and every connection (including the
  faulted request's) freezes while the process stays alive — a wedged
  gateway. Releasable like ``proc_hang`` (:func:`clear` /
  :func:`install` wake it); under the fleet router nothing clears the
  plan and the worker is SIGKILLed past the drain grace.

Plans come from the environment (``WATERNET_FAULTS="nan@3,sigterm@10"``,
read once by :func:`install_from_env`, which train.py calls) or from tests
via :func:`install`. With no plan installed every hook is a single ``is
None`` check — zero overhead on the hot path. Events are one-shot: a replay
of the same batch after a sentinel rollback does NOT re-fire the fault
(matching reality, where the skip removes the offending batch).

File-corruption helpers (:func:`truncate_file`,
:class:`FaultInjectingCapture`) are exported for tests that corrupt PNGs
and video streams directly.
"""

from __future__ import annotations

import os
import signal
import threading
from pathlib import Path
from typing import NamedTuple

_PLAN: "FaultPlan | None" = None  # guarded-by: _SERVE_LOCK (hot-path reads are lock-free `is None` checks by design)
_IMREAD_CALLS = 0  # guarded-by: _IMREAD_LOCK
_IMREAD_LOCK = threading.Lock()
_LAUNCH_CALLS = 0  # guarded-by: _SERVE_LOCK
_ADMIT_CALLS = 0  # guarded-by: _SERVE_LOCK
_COMPLETE_CALLS = 0  # guarded-by: _SERVE_LOCK
_STREAM_SESSIONS = 0  # guarded-by: _SERVE_LOCK
_FRAME_DECODES = 0  # guarded-by: _SERVE_LOCK
_GATEWAY_CALLS = 0  # guarded-by: _SERVE_LOCK
_SERVE_LOCK = threading.Lock()
#: Release latch for armed ``replica_hang`` events: a wedged launch thread
#: waits on this, and :func:`install` / :func:`clear` set it — so a test
#: (or an operator fire drill) can un-wedge the "hung device" on cue and
#: every thread stays joinable.
_HANG_RELEASE = threading.Event()  # guarded-by: _SERVE_LOCK (rebinding; the Event itself is thread-safe)


class FaultPlan:
    """One-shot fault events keyed by (kind, ordinal)."""

    KINDS = (
        "nan", "sigterm", "proc_kill", "proc_hang", "truncate_ckpt",
        "decode",
        "slow_replica", "replica_crash", "replica_hang", "nan_output",
        "reject_admit", "stream_stall", "stream_disconnect",
        "frame_corrupt", "gateway_crash", "gateway_hang",
    )

    def __init__(self, events=()):
        self._pending = set()
        for kind, at in events:
            if kind not in self.KINDS:
                raise ValueError(f"unknown fault kind {kind!r} (have {self.KINDS})")
            self._pending.add((kind, int(at)))
        self.fired: list = []

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """``"nan@3,sigterm@10"`` -> plan. Whitespace tolerated."""
        events = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            kind, _, at = part.partition("@")
            if not at:
                raise ValueError(f"fault {part!r} needs '@<step>'")
            events.append((kind.strip(), int(at)))
        return cls(events)

    def fire(self, kind: str, at: int) -> bool:
        """Consume the (kind, at) event if armed. One-shot."""
        key = (kind, int(at))
        if key in self._pending:
            self._pending.remove(key)
            self.fired.append(key)
            return True
        return False

    def __bool__(self):
        return bool(self._pending)


def install(plan: FaultPlan | None) -> None:
    global _PLAN, _IMREAD_CALLS, _LAUNCH_CALLS, _ADMIT_CALLS
    global _COMPLETE_CALLS, _STREAM_SESSIONS, _FRAME_DECODES
    global _GATEWAY_CALLS, _HANG_RELEASE
    with _SERVE_LOCK:
        # Release any launch thread wedged by the PREVIOUS plan's
        # replica_hang before swapping latches: hangs are releasable by
        # contract (the thread-leak guard depends on it). The swap
        # happens under the same lock that fires hang events, so a
        # thread that drew hang=True always holds the latch its plan
        # armed — it can never miss its release by racing the swap.
        _HANG_RELEASE.set()
        _PLAN = plan
        if plan is not None:
            _HANG_RELEASE = threading.Event()  # fresh latch for this plan
        _LAUNCH_CALLS = 0
        _ADMIT_CALLS = 0
        _COMPLETE_CALLS = 0
        _STREAM_SESSIONS = 0
        _FRAME_DECODES = 0
        _GATEWAY_CALLS = 0
    with _IMREAD_LOCK:
        _IMREAD_CALLS = 0


def clear() -> None:
    install(None)


def active() -> FaultPlan | None:
    return _PLAN


def install_from_env(env: str = "WATERNET_FAULTS") -> FaultPlan | None:
    spec = os.environ.get(env)
    if spec:
        install(FaultPlan.parse(spec))
    return _PLAN


# ----------------------------------------------------------------------
# Hooks — called from the trainer / checkpoint manager hot paths.
# ----------------------------------------------------------------------


def after_train_step(engine, metrics, global_step: int):
    """Hook run after each dispatched train step.

    Returns the (possibly poisoned) per-step metrics mapping. ``nan`` events
    poison the live model's float parameters in place and override the step's
    metrics with NaN — exactly what a non-finite gradient does to Adam.
    """
    if _PLAN is None:
        return metrics
    if _PLAN.fire("nan", global_step):
        import torch

        # In place, as a non-finite gradient leaves them; the metrics become
        # NaN tensors on the step's device, so the deferred fetch reads them
        # like any other step's.
        with torch.no_grad():
            for p in engine.model.parameters():
                if p.is_floating_point():
                    p.mul_(float("nan"))
        metrics = {k: torch.full_like(v, float("nan")) for k, v in metrics.items()}
    if _PLAN.fire("sigterm", global_step):
        os.kill(os.getpid(), signal.SIGTERM)
    if _PLAN.fire("proc_kill", global_step):
        # Hard self-terminate: no drain, no checkpoint, no Python teardown
        # (SIGKILL is uncatchable) — an OOM kill / unannounced preemption.
        os.kill(os.getpid(), signal.SIGKILL)
    with _SERVE_LOCK:
        hang = _HANG_RELEASE if _PLAN.fire("proc_hang", global_step) else None
    if hang is not None:
        # Wedge without heartbeating: block the dispatch thread on the
        # plan's release latch (same contract as replica_hang — clear()/
        # install() release it, so in-process tests stay joinable; under
        # the supervisor nothing does, and the heartbeat timeout reaps us).
        hang.wait()
    return metrics


def imread_should_fail() -> bool:
    """Hook run before each ``cv2.imread`` attempt in
    :meth:`waternet_tpu_torch.data.uieb.UIEBDataset._imread_retry`.

    Returns True when this attempt should be treated as a decode failure
    (kind ``decode``, keyed by a process-global attempt counter guarded by
    a lock — pipeline workers call this concurrently). With no plan
    installed this is a single ``is None`` check.
    """
    global _IMREAD_CALLS
    if _PLAN is None:
        return False
    with _IMREAD_LOCK:
        _IMREAD_CALLS += 1
        return _PLAN.fire("decode", _IMREAD_CALLS)


class LaunchFault(NamedTuple):
    """What the K-th bucketed batch launch should do (one counter, three
    serving-side kinds — the ordinal in ``slow_replica@K`` /
    ``replica_crash@K`` / ``replica_hang@K`` is the same launch count).
    ``hang`` is None, or the release :class:`threading.Event` the armed
    plan owns — captured atomically with the fire, so the wedged thread
    always waits on the latch that :func:`clear`/:func:`install` will
    set for it."""

    delay: float
    crash: bool
    hang: "threading.Event | None"


_NO_LAUNCH_FAULT = LaunchFault(0.0, False, None)


def replica_launch_fault() -> LaunchFault:
    """Hook run before each bucketed batch launch in
    :meth:`waternet_tpu.serving.replicas._Replica._launch_loop`.

    Keyed by a process-global launch counter across every replica's (and
    every tier pool's) launch thread, under a lock. ``delay`` is the
    seconds this launch should stall (kind ``slow_replica``, from
    ``WATERNET_FAULT_SLOW_SEC``, default 0.25); ``crash`` means the
    launch must raise (kind ``replica_crash``); a non-None ``hang`` is
    the release latch the launch must block on (kind ``replica_hang`` —
    the latch is set by :func:`clear`/:func:`install`, making every
    injected wedge releasable). With no plan installed this is a single
    ``is None`` check.
    """
    global _LAUNCH_CALLS
    if _PLAN is None:
        return _NO_LAUNCH_FAULT
    with _SERVE_LOCK:
        _LAUNCH_CALLS += 1
        k = _LAUNCH_CALLS
        delay = (
            float(os.environ.get("WATERNET_FAULT_SLOW_SEC", "0.25"))
            if _PLAN.fire("slow_replica", k)
            else 0.0
        )
        crash = _PLAN.fire("replica_crash", k)
        hang = _HANG_RELEASE if _PLAN.fire("replica_hang", k) else None
    return LaunchFault(delay, crash, hang)


def replica_launch_delay() -> float:
    """Back-compat form of :func:`replica_launch_fault` for callers that
    only stall (same counter: one call = one launch ordinal)."""
    return replica_launch_fault().delay


def poison_replica_output(arr):
    """Hook run on each completed serving batch's host array, after the
    D2H sync in :meth:`waternet_tpu.serving.replicas._Replica._complete_loop`.

    Kind ``nan_output``, keyed by a process-global completed-batch
    counter. When armed for this ordinal, returns a poisoned copy —
    float arrays go non-finite, integer arrays go all-zero: the two
    signatures the pool's output sanity guard detects. Otherwise returns
    ``arr`` unchanged; with no plan installed this is a single ``is
    None`` check.
    """
    global _COMPLETE_CALLS
    if _PLAN is None:
        return arr
    with _SERVE_LOCK:
        _COMPLETE_CALLS += 1
        fired = _PLAN.fire("nan_output", _COMPLETE_CALLS)
    if not fired:
        return arr
    import numpy as np

    out = np.array(arr)
    if np.issubdtype(out.dtype, np.floating):
        out[...] = np.nan
    else:
        out[...] = 0
    return out


def admit_should_reject() -> bool:
    """Hook run at each HTTP front-door admission attempt
    (waternet_tpu/serving/server.py).

    Returns True when this admission should be force-shed with 429 (kind
    ``reject_admit``, keyed by a process-global admission counter). With
    no plan installed this is a single ``is None`` check.
    """
    global _ADMIT_CALLS
    if _PLAN is None:
        return False
    with _SERVE_LOCK:
        _ADMIT_CALLS += 1
        return _PLAN.fire("reject_admit", _ADMIT_CALLS)


class StreamSessionFault(NamedTuple):
    """What the K-th opened stream session should suffer. ``stall`` means
    the session behaves as a wedged consumer (every delivery sleeps
    ``WATERNET_FAULT_STALL_SEC`` before the write); ``disconnect_after``
    is None, or the frame count after which the session's reader must
    simulate a peer reset (kind ``stream_disconnect``)."""

    stall: bool
    disconnect_after: "int | None"


_NO_STREAM_FAULT = StreamSessionFault(False, None)


def stream_session_fault() -> StreamSessionFault:
    """Hook run once per stream session open in
    :class:`waternet_tpu.serving.streams.StreamManager`.

    Keyed by a process-global session-open counter under a lock (kinds
    ``stream_stall`` and ``stream_disconnect`` share the ordinal: the
    K-th session opened). With no plan installed this is a single ``is
    None`` check.
    """
    global _STREAM_SESSIONS
    if _PLAN is None:
        return _NO_STREAM_FAULT
    with _SERVE_LOCK:
        _STREAM_SESSIONS += 1
        k = _STREAM_SESSIONS
        stall = _PLAN.fire("stream_stall", k)
        disconnect = _PLAN.fire("stream_disconnect", k)
    after = (
        int(os.environ.get("WATERNET_FAULT_DISCONNECT_FRAMES", "2"))
        if disconnect
        else None
    )
    return StreamSessionFault(stall, after)


def stream_stall_sec() -> float:
    """How long a stalled stream session sleeps before each delivery."""
    return float(os.environ.get("WATERNET_FAULT_STALL_SEC", "0.25"))


def frame_should_corrupt() -> bool:
    """Hook run before each stream frame decode attempt
    (waternet_tpu/serving/streams.py).

    Returns True when this frame must be treated as undecodable (kind
    ``frame_corrupt``, keyed by a process-global frame-decode counter
    across every stream session, under a lock). With no plan installed
    this is a single ``is None`` check.
    """
    global _FRAME_DECODES
    if _PLAN is None:
        return False
    with _SERVE_LOCK:
        _FRAME_DECODES += 1
        return _PLAN.fire("frame_corrupt", _FRAME_DECODES)


class GatewayFault(NamedTuple):
    """What the K-th ``/enhance`` arrival at this serving process should
    do (one per-process counter, two kinds sharing the ordinal).
    ``crash`` means SIGKILL self before answering; ``hang`` is None, or
    the release :class:`threading.Event` the armed plan owns — the
    handler blocks the event loop thread on it, freezing ``/healthz``
    and heartbeats together, which is exactly the signature the fleet
    router's hang detection exists to catch."""

    crash: bool
    hang: "threading.Event | None"


_NO_GATEWAY_FAULT = GatewayFault(False, None)


def gateway_fault() -> GatewayFault:
    """Hook run once per ``/enhance`` arrival at the HTTP front door
    (waternet_tpu/serving/server.py), before admission.

    Keyed by a per-process arrival counter under a lock (kinds
    ``gateway_crash`` and ``gateway_hang`` share the ordinal: the K-th
    enhance request THIS worker sees). Arrivals 1..K-1 are answered
    normally, so a fleet bench can pin exactly which in-flight request
    the failover must re-dispatch. With no plan installed this is a
    single ``is None`` check.
    """
    global _GATEWAY_CALLS
    if _PLAN is None:
        return _NO_GATEWAY_FAULT
    with _SERVE_LOCK:
        _GATEWAY_CALLS += 1
        k = _GATEWAY_CALLS
        crash = _PLAN.fire("gateway_crash", k)
        hang = _HANG_RELEASE if _PLAN.fire("gateway_hang", k) else None
    return GatewayFault(crash, hang)


def after_checkpoint_save(path, ordinal: int) -> None:
    """Hook run (process 0 only) after the ``ordinal``-th finalized save."""
    if _PLAN is None:
        return
    if _PLAN.fire("truncate_ckpt", ordinal):
        victim = largest_file(path)
        if victim is not None:
            truncate_file(victim, keep_bytes=max(1, victim.stat().st_size // 3))


# ----------------------------------------------------------------------
# File / stream corruption helpers for tests.
# ----------------------------------------------------------------------


def largest_file(root) -> Path | None:
    files = [p for p in Path(root).rglob("*") if p.is_file()]
    return max(files, key=lambda p: p.stat().st_size, default=None)


def truncate_file(path, keep_bytes: int = 16) -> Path:
    """Truncate ``path`` in place to ``keep_bytes`` (simulated torn write)."""
    path = Path(path)
    data = path.read_bytes()[:keep_bytes]
    path.write_bytes(data)
    return path


class FaultInjectingCapture:
    """cv2.VideoCapture look-alike that fails decode at chosen frame indices.

    Mimics the backend contract :func:`waternet_tpu_torch.data.video._read_batch`
    relies on: a mid-stream decode failure still *advances*
    ``CAP_PROP_POS_FRAMES`` (grab succeeded, retrieve failed) while EOF does
    not. Wraps either a real capture or a list of frames.
    """

    def __init__(self, frames, bad_indices=(), frame_count=None):
        self._frames = list(frames)
        self._bad = set(int(i) for i in bad_indices)
        self._pos = 0
        self._count = len(self._frames) if frame_count is None else frame_count

    def read(self):
        if self._pos >= len(self._frames):
            return False, None
        i = self._pos
        self._pos += 1  # grab advances even when retrieve (decode) fails
        if i in self._bad:
            return False, None
        return True, self._frames[i]

    def grab(self):
        if self._pos >= len(self._frames):
            return False
        self._pos += 1
        return True

    def get(self, prop):
        import cv2

        if prop == cv2.CAP_PROP_POS_FRAMES:
            return float(self._pos)
        if prop == cv2.CAP_PROP_FRAME_COUNT:
            return float(self._count)
        return 0.0
