"""looptrace: dynamic event-loop-lag watchdog (runtime companion of R201).

The JAX package's ``analysis/looptrace.py``, lifted (it imports nothing
of JAX); the port's server samples event-loop lag through it
(``--obs-loop-lag``).

The static side (the JAX package's ``analysis/rules/asynclint.py``, rule
R201) proves from source that no coroutine reaches known-blocking work
on the loop thread. This module watches what actually happens: a
:class:`LoopTracer` monkeypatches ``asyncio.events.Handle._run`` — the
single funnel every loop callback, task step, and reader/writer
completion goes through — and records each callback's wall time.  Any
single callback past ``threshold_ms`` is a **stall**: for that long,
every open connection, heartbeat, and timer on that loop froze
together.  At teardown :meth:`LoopTracer.assert_no_stall` fails the
test, printing the offending callback (``functools.partial`` chains
unwrapped to the underlying function's ``module.qualname``).

This mirrors the ``CompileSentinel``/``LockTracer`` mold from
docs/LINT.md: the static rule catches hazards visible in the source,
the fixture catches the ones that are not — blocking work reached
through C extensions, data-dependent slow paths, or third-party
callables the may-block fixpoint cannot see.  Usage (see
tests/conftest.py for the ``looptrace`` fixture)::

    tracer = LoopTracer(threshold_ms=500.0)
    tracer.install()
    try:
        ...  # exercise the asyncio code
    finally:
        tracer.uninstall()
    tracer.assert_no_stall()

Design notes:

* The patch is process-wide and thread-agnostic: loops running on
  background threads (``ServingServer.start_background``) are traced
  too, which is exactly where the serving stack runs them in tests.
  Recording takes a real (never-traced) lock only on the slow path.
* Install/uninstall nest LIFO like ``LockTracer``: each tracer captures
  whatever ``_run`` it saw at install time and restores it, so a
  production gauge tracer (``--obs-loop-lag``) and a test fixture can
  coexist.
* Wall-time thresholds on a loaded 1-core box are noisy — scheduler
  preemption charges *someone else's* CPU time to whatever callback was
  running. Pick thresholds well above legitimate callback cost (the
  conftest fixture defaults to 500 ms, overridable via
  ``LOOPTRACE_THRESHOLD_MS``); ``threshold_ms=float("inf")`` records
  lag without ever failing, which is what the production gauge uses.
* ``samples`` is a bounded ring (:class:`collections.deque`), so the
  p99 in :meth:`gauge` is over the most recent ``sample_limit``
  callbacks — deterministic, O(1) memory under sustained load.
"""

from __future__ import annotations

import asyncio.events
import collections
import functools
import threading
import time
from typing import Deque, List, NamedTuple, Optional

__all__ = [
    "LoopTracer",
    "Stall",
    "describe_callback",
    "empty_loop_lag_block",
]

_REAL_LOCK = threading.Lock


def empty_loop_lag_block() -> dict:
    """The all-zeros ``loop_lag`` stats block (``--obs-loop-lag`` off):
    same keys as a live gauge so schema consumers never branch."""
    return {
        "enabled": False,
        "max_ms": 0.0,
        "p99_ms": 0.0,
        "callbacks": 0,
        "stalls": 0,
    }


class Stall(NamedTuple):
    """One callback that held the loop past the threshold."""

    wall_ms: float
    callback: str
    thread: str

    def render(self) -> str:
        return f"{self.wall_ms:.1f} ms in {self.callback} (thread {self.thread!r})"


def describe_callback(handle) -> str:
    """Human name of a Handle's callback: partial chains unwrapped,
    bound methods resolved, ``module.qualname`` preferred."""
    cb = getattr(handle, "_callback", None)
    while isinstance(cb, functools.partial):
        cb = cb.func
    cb = getattr(cb, "__func__", cb)
    qual = getattr(cb, "__qualname__", None)
    if qual is None:
        return repr(cb)
    mod = getattr(cb, "__module__", None)
    return f"{mod}.{qual}" if mod else qual


class LoopTracer:
    """Record per-callback event-loop occupancy; fail on stalls."""

    def __init__(
        self, threshold_ms: float = 500.0, sample_limit: int = 2048
    ):
        self.threshold_ms = threshold_ms
        self.max_ms = 0.0
        self.max_callback: Optional[str] = None
        self.stalls: List[Stall] = []
        self.samples: Deque[float] = collections.deque(maxlen=sample_limit)
        self.callbacks = 0
        self._guts = _REAL_LOCK()
        self._orig = None
        self._installed = False

    # -- Handle._run patching ---------------------------------------------

    def install(self) -> None:
        if self._installed:
            return
        tracer = self
        orig = asyncio.events.Handle._run
        self._orig = orig

        def _run(handle):
            t0 = time.perf_counter()
            try:
                return orig(handle)
            finally:
                tracer._record(handle, (time.perf_counter() - t0) * 1000.0)

        asyncio.events.Handle._run = _run
        self._installed = True

    def uninstall(self) -> None:
        if not self._installed:
            return
        asyncio.events.Handle._run = self._orig
        self._orig = None
        self._installed = False

    # -- hot path ----------------------------------------------------------

    def _record(self, handle, wall_ms: float) -> None:
        with self._guts:
            self.callbacks += 1
            self.samples.append(wall_ms)
            if wall_ms > self.max_ms:
                self.max_ms = wall_ms
                self.max_callback = describe_callback(handle)
            if wall_ms >= self.threshold_ms:
                self.stalls.append(
                    Stall(
                        wall_ms,
                        describe_callback(handle),
                        threading.current_thread().name,
                    )
                )

    # -- teardown analysis / gauge ----------------------------------------

    def p99_ms(self) -> float:
        """p99 over the retained sample window (0.0 when empty)."""
        with self._guts:
            samples = sorted(self.samples)
        if not samples:
            return 0.0
        return samples[min(len(samples) - 1, int(0.99 * (len(samples) - 1)))]

    def gauge(self) -> dict:
        """The ``loop_lag`` stats block (``/stats`` + ``/metrics``)."""
        with self._guts:
            max_ms, callbacks, stalls = (
                self.max_ms, self.callbacks, len(self.stalls)
            )
        return {
            "max_ms": round(max_ms, 3),
            "p99_ms": round(self.p99_ms(), 3),
            "callbacks": callbacks,
            "stalls": stalls,
        }

    def assert_no_stall(self) -> None:
        if not self.stalls:
            return
        lines = [
            f"looptrace: event loop blocked past {self.threshold_ms:.0f} ms "
            f"by a single callback ({len(self.stalls)} stall(s)):"
        ]
        for stall in self.stalls:
            lines.append("  " + stall.render())
        lines.append(
            "Each stall froze every connection, beat, and timer on that "
            "loop simultaneously; move the work to run_in_executor/"
            "to_thread (jaxlint R201 checks the visible cases statically "
            "— see docs/LINT.md)."
        )
        raise AssertionError("\n".join(lines))
