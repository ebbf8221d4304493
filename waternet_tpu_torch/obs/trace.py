"""Bounded ring-buffer span recorder + Chrome trace-event export.

The JAX package's ``obs/trace.py``, lifted (it imports nothing of JAX).
The trainer's epoch driver records its ``step_dispatch`` and
``metrics_fetch`` spans here when tracing is enabled; the inference
engines and ``utils/tensor.py::ten2arr`` record their stages
(``obs/stages.py``), each with the device's time between two timing
events (:meth:`TraceRecorder.record_span_timed`).

Design constraints, in order:

* **Disabled means free.** Every recording hook starts with a single
  attribute load + bool check and returns; no lock, no allocation, no
  clock read. Serving and training keep their existing timestamps
  (``t_submit``/``t_admit``/``entry.t0``/the completion thread's one
  D2H) — the recorder never adds a sync point of its own.
* **Enabled means bounded.** Spans land in a fixed-size ring; when it
  wraps, the oldest span is overwritten and an eviction counter bumps.
  Memory is O(capacity) forever, independent of load duration.
* **Lock-light, thread-safe.** One plain ``threading.Lock`` guards the
  ring; the critical section is a few slot writes (no I/O, no clock, no
  allocation beyond the event tuple built outside the lock). Monotonic
  ``time.perf_counter()`` timestamps throughout — export rebases them
  onto a microsecond epoch for Perfetto.
* **No threads of its own.** Export is an explicit call (CLI, bench, or
  test); there is no background flusher to leak, so the conftest
  thread-leak guard has nothing to chase.
* **Device time as an argument, never as an event.** A span whose device
  time is not known yet waits in a bounded pending list until the device
  has passed its end event, then lands as an ordinary span with
  ``args["device_ms"]``. Nothing here imports torch: the events are
  duck-typed (``query()``, ``elapsed_time(other)``).

The export is standard Chrome trace-event JSON (``ph: "X"`` complete
spans, ``ph: "i"`` instants, ``ph: "M"`` thread-name metadata), so
``chrome://tracing`` and https://ui.perfetto.dev open it directly.
Per-request parentage is carried in ``args.request_id`` — every span a
request touches (queue wait, coalesce, device, re-dispatch hop, frame
delivery) carries the same id the front door echoed in
``X-Request-Id``. ``otherData["wall_epoch_ns"]`` is the wall clock
(``time.time_ns()``) at the export's zero: ``ts`` plus it is the clock a
``torch.profiler`` trace's ``baseTimeNanoseconds`` plus ``ts`` gives, so
the two lay over one another.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, List, Optional, Tuple

#: Default ring capacity: 64k spans ≈ a few minutes of busy serving;
#: ~100 B/span resident.
DEFAULT_CAPACITY = 1 << 16

#: Spans waiting for their device time at most; one more is recorded at
#: once, without ``device_ms``, and counted in ``pending_overflow``.
PENDING_CAPACITY = 1024

#: Single-process traces pin pid 0; the supervisor-timeline renderer in
#: the JAX package's ``obs/cli.py`` uses synthetic pids per generation.
TRACE_PID = 0


def new_request_id() -> str:
    """A fresh correlation id (16 hex chars) for ``X-Request-Id``."""
    return uuid.uuid4().hex[:16]


class TraceRecorder:
    """Thread-safe bounded span recorder.

    Events are tuples ``(name, cat, ph, t0, dur, tid, args)`` with
    ``perf_counter`` seconds; :meth:`to_chrome` rebases them onto the
    recorder's epoch (its construction or last :meth:`reset`) in
    microseconds.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self._capacity = int(capacity)
        self._pending_capacity = PENDING_CAPACITY
        self._lock = threading.Lock()
        # The epoch on both clocks, read together.
        # guarded-by: self._lock
        self._epoch = time.perf_counter()
        # guarded-by: self._lock
        self._wall_epoch_ns = time.time_ns()
        # guarded-by: self._lock
        self._ring: List[Optional[tuple]] = [None] * self._capacity
        # guarded-by: self._lock
        self._head = 0
        # guarded-by: self._lock
        self._count = 0
        # guarded-by: self._lock
        self._evicted = 0
        # guarded-by: self._lock
        self._thread_names: Dict[int, str] = {}
        # [(event tuple, thread name, start event, end event)] waiting for
        # the device to pass the end event (record_span_timed).
        # guarded-by: self._lock
        self._pending: List[tuple] = []
        # guarded-by: self._lock
        self._pending_overflow = 0
        # Bumped by reset(): pending spans taken out before it are dropped.
        # guarded-by: self._lock
        self._generation = 0
        # Hot paths read this flag without the lock (a stale read merely
        # drops or keeps one span across the enable edge); writes hold it.
        # guarded-by: self._lock
        self._enabled = False

    # -- arm / disarm ----------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        with self._lock:
            self._enabled = True

    def disable(self) -> None:
        with self._lock:
            self._enabled = False

    def reset(self) -> None:
        """Drop every recorded and pending span, zero the counters and read
        the epoch anew."""
        with self._lock:
            self._ring = [None] * self._capacity
            self._head = 0
            self._count = 0
            self._evicted = 0
            self._thread_names = {}
            self._pending = []
            self._pending_overflow = 0
            self._generation += 1
            self._epoch = time.perf_counter()
            self._wall_epoch_ns = time.time_ns()

    # -- recording -------------------------------------------------------

    def record_span(
        self,
        name: str,
        cat: str,
        t0: float,
        t1: float,
        tid: Optional[int] = None,
        args: Optional[dict] = None,
    ) -> None:
        """Record a completed span ``[t0, t1]`` (``perf_counter`` secs).

        The timestamps come from the caller — serving/training record
        against clocks they already read, so arming the tracer adds no
        clock calls to the hot path beyond the spans' own bookkeeping.
        """
        if not self._enabled:
            return
        tname = None
        if tid is None:
            cur = threading.current_thread()
            tid = cur.ident or 0
            tname = cur.name
        self._push((name, cat, "X", t0, t1 - t0, tid, args), tid, tname)

    def record_instant(
        self,
        name: str,
        cat: str,
        t: Optional[float] = None,
        args: Optional[dict] = None,
    ) -> None:
        """Record a zero-duration marker (re-dispatch hop, frame drop…)."""
        if not self._enabled:
            return
        if t is None:
            t = time.perf_counter()
        cur = threading.current_thread()
        tid = cur.ident or 0
        self._push((name, cat, "i", t, 0.0, tid, args), tid, cur.name)

    def record_span_timed(
        self,
        name: str,
        cat: str,
        t0: float,
        t1: float,
        start_event,
        end_event,
        args: Optional[dict] = None,
    ) -> None:
        """Record the span ``[t0, t1]`` with ``args["device_ms"]``, the
        device's milliseconds from ``start_event`` to ``end_event``.

        The span waits in the pending list until ``end_event.query()`` is
        true (:meth:`resolve_pending`), then lands as an ordinary span with
        ``start_event.elapsed_time(end_event)``. Without either event it is
        recorded at once, as :meth:`record_span` would. The events are
        whatever has those two methods (``obs/stages.py``'s CUDA timing
        events); they are never waited for here.
        """
        if not self._enabled:
            return
        cur = threading.current_thread()
        tid = cur.ident or 0
        ev = (name, cat, "X", t0, t1 - t0, tid, dict(args or {}))
        if start_event is not None and end_event is not None:
            with self._lock:
                if not self._enabled:
                    return
                if len(self._pending) < self._pending_capacity:
                    self._pending.append((ev, cur.name, start_event, end_event))
                    return
                self._pending_overflow += 1
        self._push(ev, tid, cur.name)

    def resolve_pending(self) -> int:
        """Record each pending span whose end event the device has passed,
        with its ``device_ms``; returns how many are still pending. The
        events are asked outside the lock. A span taken in while armed
        lands even if the recorder was disarmed since; one taken in before
        a :meth:`reset` is dropped."""
        with self._lock:
            pending, self._pending = self._pending, []
            generation = self._generation
        if not pending:
            return 0
        ready, waiting = [], []
        for item in pending:
            (ready if item[3].query() else waiting).append(item)
        for ev, _, start, end in ready:
            ev[6]["device_ms"] = start.elapsed_time(end)
        with self._lock:
            if generation != self._generation:
                return len(self._pending)
            self._pending[:0] = waiting
            for ev, tname, _, _ in ready:
                self._push_locked(ev, ev[5], tname)
            return len(self._pending)

    @contextmanager
    def span(self, name: str, cat: str = "app", **args):
        """Context manager convenience for code-shaped spans."""
        if not self._enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record_span(name, cat, t0, time.perf_counter(), args=args or None)

    # guarded-by annotations above make the short critical section the
    # whole synchronization story: slot write + head/count bookkeeping.
    def _push(self, ev: tuple, tid: int, tname: Optional[str]) -> None:
        with self._lock:
            if not self._enabled:
                return
            self._push_locked(ev, tid, tname)

    def _push_locked(self, ev: tuple, tid: int, tname: Optional[str]) -> None:  # guarded-by: self._lock
        if tname is not None and tid not in self._thread_names:
            self._thread_names[tid] = tname
        if self._count == self._capacity:
            self._evicted += 1
        else:
            self._count += 1
        self._ring[self._head] = ev
        self._head = (self._head + 1) % self._capacity

    # -- introspection / export ------------------------------------------

    def counters(self) -> dict:
        """``{"spans", "evicted", "capacity", "pending",
        "pending_overflow"}`` — 'spans' is resident, 'pending' waits for its
        device time, 'pending_overflow' landed without it."""
        with self._lock:
            return {
                "spans": self._count,
                "evicted": self._evicted,
                "capacity": self._capacity,
                "pending": len(self._pending),
                "pending_overflow": self._pending_overflow,
            }

    def snapshot(self) -> Tuple[List[tuple], Dict[int, str]]:
        """Resident events in the order they landed (a span with device
        time lands when the device has passed it), plus the thread-name
        map; pending spans the device has passed are resolved first."""
        self.resolve_pending()
        with self._lock:
            if self._count < self._capacity:
                evs = self._ring[: self._count]
            else:
                evs = self._ring[self._head :] + self._ring[: self._head]
            return [e for e in evs if e is not None], dict(self._thread_names)

    def to_chrome(self) -> dict:
        """The trace as a Chrome trace-event JSON object (Perfetto-ready);
        ``otherData`` holds :meth:`counters` and ``wall_epoch_ns``."""
        evs, names = self.snapshot()
        counters = self.counters()
        with self._lock:
            epoch, wall_epoch_ns = self._epoch, self._wall_epoch_ns
        out: List[dict] = [
            {
                "ph": "M",
                "name": "thread_name",
                "pid": TRACE_PID,
                "tid": tid,
                "args": {"name": tname},
            }
            for tid, tname in sorted(names.items())
        ]
        for name, cat, ph, t0, dur, tid, args in evs:
            ev = {
                "name": name,
                "cat": cat,
                "ph": ph,
                "pid": TRACE_PID,
                "tid": tid,
                "ts": round((t0 - epoch) * 1e6, 3),
            }
            if ph == "X":
                ev["dur"] = round(dur * 1e6, 3)
            elif ph == "i":
                ev["s"] = "t"  # thread-scoped instant
            if args:
                ev["args"] = dict(args)
            out.append(ev)
        return {
            "traceEvents": out,
            "displayTimeUnit": "ms",
            "otherData": dict(counters, wall_epoch_ns=wall_epoch_ns),
        }

    def export_chrome(self, path) -> dict:
        """Write :meth:`to_chrome` to ``path``; returns the document."""
        doc = self.to_chrome()
        Path(path).write_text(json.dumps(doc))
        return doc


#: Process-wide recorder: serving, training, and bench all record here so
#: one export holds the whole story. Never reassigned.
_RECORDER = TraceRecorder()


def recorder() -> TraceRecorder:
    return _RECORDER


def enabled() -> bool:
    return _RECORDER.enabled


def enable() -> None:
    _RECORDER.enable()


def disable() -> None:
    _RECORDER.disable()


def reset() -> None:
    _RECORDER.reset()


def record_span(name, cat, t0, t1, tid=None, args=None) -> None:
    _RECORDER.record_span(name, cat, t0, t1, tid=tid, args=args)


def record_span_timed(name, cat, t0, t1, start_event, end_event, args=None) -> None:
    _RECORDER.record_span_timed(name, cat, t0, t1, start_event, end_event, args=args)


def resolve_pending() -> int:
    return _RECORDER.resolve_pending()


def record_instant(name, cat, t=None, args=None) -> None:
    _RECORDER.record_instant(name, cat, t=t, args=args)


def span(name, cat="app", **args):
    return _RECORDER.span(name, cat, **args)


def counters() -> dict:
    return _RECORDER.counters()


def export(path) -> dict:
    return _RECORDER.export_chrome(path)
