"""locktrace: dynamic lock-order watchdog (runtime companion of R102).

The static side (:mod:`waternet_tpu_torch.analysis.rules.concurrency`, rule
R102) proves the *declared* lock-acquisition graph acyclic from source.
This module watches the graph that actually happens: a
:class:`LockTracer` monkeypatches the ``threading.Lock`` /
``threading.RLock`` factories so every lock created while it is
installed is wrapped in a :class:`TracedLock` that records, per thread,
the stack of locks currently held.  Whenever a thread acquires lock B
while holding lock A, the tracer records an ordered edge ``A -> B``
keyed by each lock's *creation site* (``file:line`` of the ``Lock()``
call) together with the acquiring thread's stack — the first time only,
so the hot path stays a dict lookup.  At teardown
:meth:`LockTracer.assert_acyclic` fails the test if the observed edges
contain a cycle, printing both directions' acquisition stacks.

The JAX package's ``analysis/locktrace.py``, lifted (it imports nothing
of JAX). The static rule catches hazards visible in the source, the
tracer catches the ones that are not — lock orders induced through
callbacks, executor threads, or data-dependent branches that static
call-graph propagation cannot see. ``chip_smoke.py`` runs the serving
path on the card under it. Usage::

    tracer = LockTracer()
    tracer.install()
    try:
        ...  # exercise the threaded code
    finally:
        tracer.uninstall()
    tracer.assert_acyclic()

Design notes:

* Lock identity is the **creation site**, not the instance: a pool that
  builds one ``threading.Lock()`` per replica on the same line is one
  node, matching R102's declaration-site :class:`LockKey` semantics (and
  keeping the graph finite under churn).  Reentrant re-acquisition of
  the same site never records an edge.
* ``threading.Condition`` built with a default lock goes through the
  patched ``RLock`` factory, so condition-protected state is traced too.
  :class:`TracedLock` delegates ``_is_owned`` / ``_release_save`` /
  ``_acquire_restore`` to the wrapped lock via ``__getattr__`` — the
  exact attributes ``Condition`` probes with ``hasattr`` — so a traced
  RLock stays a valid Condition substrate.  ``Condition.wait`` releases
  and reacquires through those *delegated* methods, bypassing the
  tracer: the lock is treated as held across the wait, which is the
  conservative (and for ordering purposes, correct) reading.
* Locks created *before* ``install()`` (module-level locks, pytest
  internals) are untraced; the fixture window means tests trace exactly
  the objects they construct.
* ``acquire(blocking=False)`` that fails records nothing — only an
  acquisition that actually succeeded can contribute to a deadlock
  order.
"""

from __future__ import annotations

import sys
import threading
import traceback
from typing import Dict, List, Optional, Tuple

__all__ = ["LockTracer", "TracedLock"]

# The tracer's own guts must never run through the tracing machinery.
_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock


def _creation_site(depth: int = 2) -> str:
    """``file:line`` of the frame ``depth`` levels up (the ``Lock()`` call)."""
    f = sys._getframe(depth)
    return f"{f.f_code.co_filename}:{f.f_lineno}"


class TracedLock:
    """Wrap a real lock; report successful acquires/releases to a tracer."""

    def __init__(self, inner, site: str, tracer: "LockTracer"):
        self._inner = inner
        self._site = site
        self._tracer = tracer

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._tracer._on_acquire(self)
        return got

    def release(self) -> None:
        self._tracer._on_release(self)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __getattr__(self, name: str):
        # Condition protocol (_is_owned/_release_save/_acquire_restore)
        # and anything else version-specific: present exactly when the
        # wrapped lock has it, so hasattr probes behave identically.
        return getattr(self._inner, name)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<TracedLock site={self._site} {self._inner!r}>"


class LockTracer:
    """Record per-thread lock-acquisition order; fail on observed cycles."""

    #: frames kept per recorded edge stack (enough to find the caller,
    #: small enough that hammer tests don't balloon).
    STACK_LIMIT = 12

    def __init__(self):
        self._tls = threading.local()
        self._guts = _REAL_LOCK()  # protects edges/sites; never traced
        # (site_a, site_b) -> (thread name, formatted acquisition stack)
        self.edges: Dict[Tuple[str, str], Tuple[str, str]] = {}
        #: creation sites seen, in creation order (graph nodes)
        self.sites: List[str] = []
        self._installed = False

    # -- factory patching -------------------------------------------------

    def install(self) -> None:
        if self._installed:
            return
        tracer = self

        def make_lock():
            return TracedLock(_REAL_LOCK(), _creation_site(), tracer)

        def make_rlock():
            return TracedLock(_REAL_RLOCK(), _creation_site(), tracer)

        threading.Lock = make_lock
        threading.RLock = make_rlock
        self._installed = True

    def uninstall(self) -> None:
        if not self._installed:
            return
        threading.Lock = _REAL_LOCK
        threading.RLock = _REAL_RLOCK
        self._installed = False

    # -- hot path ----------------------------------------------------------

    def _held(self) -> List[TracedLock]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def _on_acquire(self, lock: TracedLock) -> None:
        held = self._held()
        site = lock._site
        for prev in held:
            if prev._site == site:  # reentrant RLock: not an ordering edge
                continue
            key = (prev._site, site)
            if key not in self.edges:  # stack capture only for new edges
                stack = "".join(
                    traceback.format_stack(
                        sys._getframe(2), limit=self.STACK_LIMIT
                    )
                )
                with self._guts:
                    self.edges.setdefault(
                        key, (threading.current_thread().name, stack)
                    )
        if site not in self.sites:
            with self._guts:
                if site not in self.sites:
                    self.sites.append(site)
        held.append(lock)

    def _on_release(self, lock: TracedLock) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):  # pop last occurrence:
            if held[i] is lock:  # non-LIFO release is legal
                del held[i]
                return

    # -- teardown analysis -------------------------------------------------

    def cycle(self) -> Optional[List[str]]:
        """A list of sites forming an observed cycle, or ``None``."""
        adj: Dict[str, List[str]] = {}
        for a, b in self.edges:
            adj.setdefault(a, []).append(b)
        WHITE, GREY, BLACK = 0, 1, 2
        color = {s: WHITE for s in adj}
        for root in adj:
            if color.get(root, WHITE) != WHITE:
                continue
            stack = [(root, iter(adj.get(root, ())))]
            color[root] = GREY
            path = [root]
            while stack:
                node, it = stack[-1]
                advanced = False
                for nxt in it:
                    c = color.get(nxt, WHITE)
                    if c == GREY:
                        return path[path.index(nxt):] + [nxt]
                    if c == WHITE:
                        color[nxt] = GREY
                        path.append(nxt)
                        stack.append((nxt, iter(adj.get(nxt, ()))))
                        advanced = True
                        break
                if not advanced:
                    color[node] = BLACK
                    path.pop()
                    stack.pop()
        return None

    def assert_acyclic(self) -> None:
        cyc = self.cycle()
        if cyc is None:
            return
        lines = ["locktrace: observed lock-order cycle (deadlock hazard):"]
        lines.append("  " + " -> ".join(cyc))
        for a, b in zip(cyc, cyc[1:]):
            thread, stack = self.edges[(a, b)]
            lines.append(f"edge {a} -> {b} first seen on thread {thread!r}:")
            lines.append(stack.rstrip())
        lines.append(
            "Two threads taking these locks in opposite orders can "
            "deadlock; impose one global order (R102 checks the declared "
            "order statically: python -m waternet_tpu_torch.analysis.lint_all)."
        )
        raise AssertionError("\n".join(lines))
