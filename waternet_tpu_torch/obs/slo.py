"""SLO objectives, burn rates, and deterministic alert state machines.

The JAX package's ``obs/slo.py``, lifted (it imports nothing of JAX).

The grammar (``--slo`` on the serving CLI, ``waternet-trace slo`` for
offline replay) is a comma-separated list of objectives:

    p99_ms<=250,error_rate<=0.01,availability>=0.999

Three objective kinds, each reduced to an **error budget** and a
**burn rate** over a window (docs/OBSERVABILITY.md "Windows & SLOs"):

``p<NN>_ms<=T``
    "At least NN% of requests complete within T ms." Budget is the
    allowed slow fraction ``1 - NN/100``; burn is (fraction of windowed
    requests over T) / budget. Burn 1.0 = slow requests arriving at
    exactly the rate the SLO tolerates.
``error_rate<=T``
    Budget is ``T`` itself; burn is windowed error fraction / T.
``availability>=Y``
    Budget is ``1 - Y``; burn is windowed unavailable fraction (errors
    plus sheds) / budget.

Burn is evaluated over TWO windows from the same shard ring (short
~60 s: "is it on fire now", long ~300 s: "is it sustained") and fed to
a per-objective state machine:

    ok --[long >= warn_burn, or short >= page_burn]--> warn
    warn --[short >= page_burn AND long >= warn_burn]--> page
    page/warn --[condition clear for hold_sec]--> one level down

Escalation is immediate; de-escalation requires the triggering
condition to stay false for ``hold_sec`` so a flapping signal cannot
ping-pong the grade. All time comes from the caller (``now``
arguments) — tests and the CLI replay drive a fake clock, no sleeps.

Pure stdlib; imported by ``waternet-trace`` so it must never pull jax.
"""

from __future__ import annotations

import re
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from waternet_tpu_torch.obs import window as obswin

#: Burn thresholds and de-escalation hold, shared defaults.
WARN_BURN = 1.0
PAGE_BURN = 2.0
HOLD_SEC = 60.0

_STATES = ("ok", "warn", "page")

_P_RE = re.compile(r"^p(\d{1,2})_ms<=([0-9.]+)$")
_ERR_RE = re.compile(r"^error_rate<=([0-9.]+)$")
_AVAIL_RE = re.compile(r"^availability>=([0-9.]+)$")


class SloObjective:
    """One parsed objective: a kind, a threshold, and an error budget."""

    __slots__ = ("name", "kind", "threshold", "budget", "quantile")

    def __init__(self, name: str, kind: str, threshold: float,
                 budget: float, quantile: Optional[float] = None):
        if budget <= 0.0:
            raise ValueError(
                f"SLO objective {name!r} has zero error budget — "
                "a 100% target cannot be burn-rated"
            )
        self.name = name
        self.kind = kind
        self.threshold = threshold
        self.budget = budget
        self.quantile = quantile

    def burn(self, hist: "obswin.LogLinearHistogram",
             ok: float, errors: float, shed: float) -> float:
        """Burn rate of this objective over one window's observations.

        Empty windows burn 0 — no traffic is not an outage (the
        liveness question belongs to /healthz replica probes).
        """
        if self.kind == "latency":
            n = hist.count
            if n == 0:
                return 0.0
            slow = n - hist.count_le(self.threshold)
            return (slow / n) / self.budget
        total = ok + errors + shed
        if total <= 0:
            return 0.0
        if self.kind == "error_rate":
            return (errors / total) / self.budget
        # availability: anything that did not complete counts against it
        return ((errors + shed) / total) / self.budget


def parse_slo(spec: str) -> List[SloObjective]:
    """Parse a ``--slo`` spec string into objectives. Raises ValueError
    with the offending clause on any syntax error."""
    objectives: List[SloObjective] = []
    for raw in spec.split(","):
        clause = raw.strip()
        if not clause:
            continue
        m = _P_RE.match(clause)
        if m:
            nn = int(m.group(1))
            if not 1 <= nn <= 99:
                raise ValueError(f"SLO quantile out of range in {clause!r}")
            objectives.append(SloObjective(
                clause, "latency", float(m.group(2)),
                budget=1.0 - nn / 100.0, quantile=nn / 100.0,
            ))
            continue
        m = _ERR_RE.match(clause)
        if m:
            objectives.append(SloObjective(
                clause, "error_rate", float(m.group(1)),
                budget=float(m.group(1)),
            ))
            continue
        m = _AVAIL_RE.match(clause)
        if m:
            y = float(m.group(1))
            if not 0.0 < y < 1.0:
                raise ValueError(
                    f"availability target must be in (0, 1) in {clause!r}")
            objectives.append(SloObjective(
                clause, "availability", y, budget=1.0 - y,
            ))
            continue
        raise ValueError(
            f"unrecognized SLO clause {clause!r} "
            "(expected pNN_ms<=T, error_rate<=T, or availability>=Y)"
        )
    if not objectives:
        raise ValueError(f"empty SLO spec: {spec!r}")
    return objectives


class _ObjectiveState:
    """Deterministic per-objective alert state machine.

    NOT self-locked — owned and driven under :class:`SloEngine`'s lock.
    """

    __slots__ = ("state", "since", "_clear_since")

    def __init__(self):
        self.state = "ok"
        self.since = None  # entered-current-state timestamp
        self._clear_since = None  # condition-false-since, for hold_sec

    def step(self, now: float, short_burn: float, long_burn: float,
             hold_sec: float) -> Optional[Tuple[str, str]]:
        """Advance one evaluation; returns (old, new) on transition."""
        page_cond = short_burn >= PAGE_BURN and long_burn >= WARN_BURN
        warn_cond = long_burn >= WARN_BURN or short_burn >= PAGE_BURN
        target = "page" if page_cond else ("warn" if warn_cond else "ok")
        old = self.state
        if self.since is None:
            self.since = now
        if _STATES.index(target) > _STATES.index(old):
            # escalate immediately (and restart any de-escalation hold)
            self.state = target
            self.since = now
            self._clear_since = None
            return (old, target)
        # current level's own trigger: does this level still justify itself?
        held = page_cond if old == "page" else warn_cond
        if old == "ok" or held:
            self._clear_since = None
            return None
        if self._clear_since is None:
            self._clear_since = now
        if now - self._clear_since >= hold_sec:
            # drop exactly one level; re-arm the hold for the next drop
            self.state = _STATES[_STATES.index(old) - 1]
            self.since = now
            self._clear_since = now
            return (old, self.state)
        return None


class WindowSample:
    """One window's worth of observations handed to the engine."""

    __slots__ = ("hist", "ok", "errors", "shed")

    def __init__(self, hist: "obswin.LogLinearHistogram",
                 ok: float = 0.0, errors: float = 0.0, shed: float = 0.0):
        self.hist = hist
        self.ok = ok
        self.errors = errors
        self.shed = shed


class SloEngine:
    """Evaluates objectives against short/long window samples and keeps
    the per-objective alert state machines."""

    def __init__(self, objectives: Sequence[SloObjective], *,
                 spec: Optional[str] = None,
                 short_sec: float = obswin.DEFAULT_WINDOW_SEC,
                 long_sec: float = obswin.DEFAULT_LONG_WINDOW_SEC,
                 hold_sec: float = HOLD_SEC):
        self.objectives = list(objectives)
        self.spec = spec if spec is not None else ",".join(
            o.name for o in self.objectives)
        self.short_sec = float(short_sec)
        self.long_sec = float(long_sec)
        self.hold_sec = float(hold_sec)
        self._lock = threading.Lock()
        self._states = {  # guarded-by: self._lock
            o.name: _ObjectiveState() for o in self.objectives
        }

    def evaluate(self, now: float, short: WindowSample,
                 long: WindowSample) -> Dict[str, object]:
        """Advance every state machine one tick and return the ``slo``
        block /stats publishes."""
        rows = []
        transitions = []
        with self._lock:
            for obj in self.objectives:
                sb = obj.burn(short.hist, short.ok, short.errors, short.shed)
                lb = obj.burn(long.hist, long.ok, long.errors, long.shed)
                st = self._states[obj.name]
                tr = st.step(now, sb, lb, self.hold_sec)
                if tr is not None:
                    transitions.append(
                        {"objective": obj.name, "from": tr[0], "to": tr[1],
                         "at": round(now, 3)})
                rows.append({
                    "objective": obj.name,
                    "kind": obj.kind,
                    "threshold": obj.threshold,
                    "budget": round(obj.budget, 6),
                    "short_burn": round(sb, 4),
                    "long_burn": round(lb, 4),
                    "state": st.state,
                    "since": round(st.since, 3) if st.since is not None else None,
                })
            worst = max(
                (r["state"] for r in rows), key=_STATES.index, default="ok")
        return {
            "spec": self.spec,
            "grade": "degraded" if worst == "page" else "ok",
            "state": worst,
            "window_sec": self.short_sec,
            "long_window_sec": self.long_sec,
            "objectives": rows,
            "transitions": transitions,
        }

    def state(self) -> str:
        with self._lock:
            return max(
                (s.state for s in self._states.values()),
                key=_STATES.index, default="ok")


def replay_ledger(
    entries: Sequence[dict],
    objectives: Sequence[SloObjective],
    *,
    step_sec: float = 1.0,
    short_sec: float = obswin.DEFAULT_WINDOW_SEC,
    long_sec: float = obswin.DEFAULT_LONG_WINDOW_SEC,
    hold_sec: float = HOLD_SEC,
) -> Tuple[List[dict], Dict[str, object]]:
    """Replay a loadgen/bench ledger offline through the same windows
    and state machines the live server runs.

    Each entry: ``{"t": seconds, "latency_ms": float, "outcome": str}``
    with outcome one of ``ok`` / ``error`` / ``shed``. Entries are fed
    in time order against a fake clock; the engine is stepped every
    ``step_sec`` of ledger time. Returns (all transitions, final block).
    """
    fake = [0.0]

    def clock() -> float:
        return fake[0]

    hist = obswin.WindowedHistogram(window_sec=long_sec, clock=clock)
    counters = {
        k: obswin.WindowedCounter(window_sec=long_sec, clock=clock)
        for k in ("ok", "errors", "shed")
    }
    engine = SloEngine(objectives, short_sec=short_sec, long_sec=long_sec,
                       hold_sec=hold_sec)

    def sample(span: float) -> WindowSample:
        return WindowSample(
            hist.merged(span),
            ok=counters["ok"].total(span),
            errors=counters["errors"].total(span),
            shed=counters["shed"].total(span),
        )

    def tick() -> Dict[str, object]:
        block = engine.evaluate(fake[0], sample(short_sec), sample(long_sec))
        transitions.extend(block["transitions"])
        return block

    ordered = sorted(entries, key=lambda e: float(e.get("t", 0.0)))
    transitions: List[dict] = []
    block: Dict[str, object] = {}
    next_eval = step_sec
    for e in ordered:
        t = float(e.get("t", 0.0))
        while t >= next_eval:
            fake[0] = next_eval
            block = tick()
            next_eval += step_sec
        fake[0] = t
        outcome = str(e.get("outcome", "ok"))
        if outcome == "ok":
            counters["ok"].add(1)
            if e.get("latency_ms") is not None:
                hist.record(float(e["latency_ms"]))
        elif outcome == "shed":
            counters["shed"].add(1)
        else:
            counters["errors"].add(1)
    # One final evaluation at the first step boundary past the last
    # entry: the reported state is the state AT THE END OF THE RUN. A
    # run that ends while still paging must report page (that is the
    # CLI's rc 1) — running the clock further would let every alert
    # quietly de-escalate and hide the ending.
    end = (float(ordered[-1].get("t", 0.0)) if ordered else 0.0) + step_sec
    while next_eval <= end:
        fake[0] = next_eval
        block = tick()
        next_eval += step_sec
    return transitions, block
