"""Bounded ring-buffer span recorder + Chrome trace-event export.

The JAX package's ``obs/trace.py``, lifted (it imports nothing of JAX).
The trainer's epoch driver records its ``step_dispatch`` and
``metrics_fetch`` spans here when tracing is enabled.

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

The export is standard Chrome trace-event JSON (``ph: "X"`` complete
spans, ``ph: "i"`` instants, ``ph: "M"`` thread-name metadata), so
``chrome://tracing`` and https://ui.perfetto.dev open it directly.
Per-request parentage is carried in ``args.request_id`` — every span a
request touches (queue wait, coalesce, device, re-dispatch hop, frame
delivery) carries the same id the front door echoed in
``X-Request-Id``.
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
    recorder's construction epoch in microseconds.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self._capacity = int(capacity)
        self._epoch = time.perf_counter()
        self._lock = threading.Lock()
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
        """Drop every recorded span and zero the eviction counter."""
        with self._lock:
            self._ring = [None] * self._capacity
            self._head = 0
            self._count = 0
            self._evicted = 0
            self._thread_names = {}

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
        """``{"spans", "evicted", "capacity"}`` — 'spans' is resident."""
        with self._lock:
            return {
                "spans": self._count,
                "evicted": self._evicted,
                "capacity": self._capacity,
            }

    def snapshot(self) -> Tuple[List[tuple], Dict[int, str]]:
        """Resident events oldest→newest, plus the thread-name map."""
        with self._lock:
            if self._count < self._capacity:
                evs = self._ring[: self._count]
            else:
                evs = self._ring[self._head :] + self._ring[: self._head]
            return [e for e in evs if e is not None], dict(self._thread_names)

    def to_chrome(self) -> dict:
        """The trace as a Chrome trace-event JSON object (Perfetto-ready)."""
        evs, names = self.snapshot()
        counters = self.counters()
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
                "ts": round((t0 - self._epoch) * 1e6, 3),
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
            "otherData": counters,
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


def record_instant(name, cat, t=None, args=None) -> None:
    _RECORDER.record_instant(name, cat, t=t, args=args)


def span(name, cat="app", **args):
    return _RECORDER.span(name, cat, **args)


def counters() -> dict:
    return _RECORDER.counters()


def export(path) -> dict:
    return _RECORDER.export_chrome(path)
