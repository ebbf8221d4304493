"""Adaptive serving scheduler: load-aware coalescing + queue forecasting.

The JAX package's ``serving/adaptive.py``, lifted (it imports nothing of
JAX); the port's batcher sizes its coalescing window with
:class:`CoalesceController`.

Two small, deterministic controllers (docs/SERVING.md "Adaptive
scheduling"):

* :class:`CoalesceController` — replaces the batcher's FIXED
  ``max_wait_ms`` hold with a per-(tier, bucket) EWMA arrival-rate
  estimator. ``max_wait_ms`` becomes a CAP: when the expected number of
  batch-mates inside that cap is below ``gain_threshold`` the window
  collapses to zero (an empty-queue request flushes immediately — its
  p50 drops by ~the cap), and as arrival rate rises the window grows
  linearly toward the cap (occupancy and throughput preserved under
  load). ``mode="fixed"`` reproduces the historical constant hold
  byte-for-byte in timing semantics. Per-request deadlines clamp the
  effective window in the batcher exactly as before — this class only
  decides the coalescing budget, never the clamp. The batcher adds one
  work-conserving refinement on top (``DynamicBatcher._window_for``):
  while every replica of a tier is busy, a shrunken window is extended
  back to the cap — flushing a partial bucket early cannot start its
  compute sooner (the batch would queue behind the pool anyway), it
  only locks in a slot-padded partial fill, so under saturation the
  adaptive dispatcher coalesces exactly like the fixed hold.

* :class:`QueueForecaster` — EWMA level + slope over sampled queue
  depth, with a Little's-law drain-time estimate against the SLO's p99
  objective: ``breach_depth = service_rate * objective_sec`` is the
  depth at which the queue alone eats the whole latency budget, and the
  slope gives an ETA to that depth. The fleet supervisor scales up on a
  *predicted* breach (before the burn-rate engine pages) and down on a
  sustained low forecast; both directions are hysteresis-gated
  (``up_sustain`` / ``down_sustain`` consecutive agreeing ticks) so
  sample noise cannot flap the fleet. Pure step API like
  the JAX package's ``serving/fleet.py::FleetPolicy``: tests drive it with
  a fake clock, no sleeps.

Neither controller touches request bytes: outputs stay byte-identical
across modes — only WHEN batches form and WHEN workers scale changes.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, Optional, Tuple


class CoalesceController:
    """Per-(tier, bucket) effective coalescing window under a fixed cap.

    The dispatcher thread feeds arrivals (:meth:`observe_arrival`) and
    batch flushes (:meth:`observe_flush`) and reads the live window
    (:meth:`window_s`); the stats thread snapshots gauges
    (:meth:`eff_wait_ms`) — hence the lock.

    Controller math: each key keeps an EWMA arrival-rate estimate
    ``lam`` (req/s), updated from inter-arrival gaps with a time-decayed
    smoothing factor ``alpha = 1 - exp(-gap / tau_s)``. When reading,
    the estimate is clamped by the time since the last arrival
    (``lam_eff = min(lam, 1 / idle_gap)``) so a stale burst decays
    instead of holding the window open forever. The expected batch-mates
    inside the cap are ``E = lam_eff * max_wait_s``:

    * ``E < gain_threshold`` → window 0 (flush now: the wait would
      almost surely buy no batch-mate);
    * otherwise → ``window = max_wait_s * min(1, E / target_mates)`` —
      linear growth toward the cap as load rises.

    ``mode="fixed"`` short-circuits everything to the constant cap.
    """

    MODES = ("adaptive", "fixed")

    def __init__(
        self,
        max_wait_s: float,
        mode: str = "adaptive",
        gain_threshold: float = 0.5,
        target_mates: float = 3.0,
        tau_s: float = 0.5,
        clock=time.perf_counter,
    ):
        if mode not in self.MODES:
            raise ValueError(
                f"coalesce mode must be one of {self.MODES}, got {mode!r}"
            )
        if max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {max_wait_s}")
        if gain_threshold <= 0 or target_mates <= 0 or tau_s <= 0:
            raise ValueError(
                "gain_threshold, target_mates and tau_s must be > 0"
            )
        self.mode = mode
        self.max_wait_s = float(max_wait_s)
        self.gain_threshold = float(gain_threshold)
        self.target_mates = float(target_mates)
        self.tau_s = float(tau_s)
        self._clock = clock
        self._lock = threading.Lock()
        # (tier, bucket) -> [ewma_rate_per_sec, t_last_arrival]
        self._rate: Dict[Tuple, list] = {}  # guarded-by: self._lock
        # tier -> EWMA batch fill fraction (gauge-only; the window is
        # driven by arrival rate so it reacts BEFORE occupancy moves)
        self._occupancy: Dict[str, float] = {}  # guarded-by: self._lock

    # -- feeds (dispatcher thread) -------------------------------------

    def observe_arrival(self, tier: str, bucket, now: Optional[float] = None) -> None:
        """One request admitted into (tier, bucket)'s pending list."""
        now = self._clock() if now is None else now
        key = (tier, bucket)
        with self._lock:
            st = self._rate.get(key)
            if st is None:
                # First arrival carries no rate information yet; it
                # anchors the inter-arrival clock.
                self._rate[key] = [0.0, now]
                return
            gap = max(now - st[1], 1e-6)
            alpha = 1.0 - math.exp(-gap / self.tau_s)
            st[0] += alpha * (1.0 / gap - st[0])
            st[1] = now

    def observe_flush(self, tier: str, fill: float) -> None:
        """One batch flushed for ``tier`` at ``fill`` = real/slots."""
        fill = min(max(float(fill), 0.0), 1.0)
        with self._lock:
            prev = self._occupancy.get(tier)
            self._occupancy[tier] = (
                fill if prev is None else prev + 0.2 * (fill - prev)
            )

    # -- reads ---------------------------------------------------------

    def _window_from(self, lam: float, t_last: float, now: float) -> float:
        """Pure window math from one key's snapshot (no lock held)."""
        idle = max(now - t_last, 1e-6)
        lam_eff = min(lam, 1.0 / idle)
        expected = lam_eff * self.max_wait_s
        if expected < self.gain_threshold:
            return 0.0
        return self.max_wait_s * min(1.0, expected / self.target_mates)

    def window_s(self, tier: str, bucket, now: Optional[float] = None) -> float:
        """Effective coalescing budget for (tier, bucket), in seconds —
        always within [0, max_wait_s]. Fixed mode: the cap, always."""
        if self.mode == "fixed":
            return self.max_wait_s
        now = self._clock() if now is None else now
        with self._lock:
            st = self._rate.get((tier, bucket))
            if st is None:
                return 0.0
            lam, t_last = st[0], st[1]
        return self._window_from(lam, t_last, now)

    def eff_wait_ms(self) -> Dict[str, float]:
        """Live per-tier effective window gauge (ms): the max over that
        tier's buckets — the budget the busiest bucket is running at.
        Fixed mode reports the cap for every tier seen."""
        now = self._clock()
        with self._lock:
            snap = [(k, st[0], st[1]) for k, st in self._rate.items()]
        out: Dict[str, float] = {}
        for (tier, _bucket), lam, t_last in snap:
            if self.mode == "fixed":
                w = self.max_wait_s
            else:
                w = self._window_from(lam, t_last, now)
            out[tier] = max(out.get(tier, 0.0), round(w * 1e3, 3))
        return out

    def occupancy(self) -> Dict[str, float]:
        """EWMA batch-fill gauge per tier (what flushes have looked like
        recently; bench's serve_adaptive line reports it)."""
        with self._lock:
            return {t: round(v, 4) for t, v in self._occupancy.items()}


class QueueForecaster:
    """EWMA level+slope queue-depth forecast with Little's-law breach ETA.

    Pure decision engine: :meth:`step` is called once per control tick
    with the clock, the observed aggregate queue depth, and the current
    service rate (completed requests/sec). It returns ``"scale_up"``,
    ``"scale_down"``, or None. All state is private to the calling
    thread (the fleet monitor) — no lock needed; gauges are snapshotted
    into plain floats the summary thread reads atomically.

    * level: ``L += alpha * (depth - L)`` with ``alpha`` derived from the
      tick gap and ``tau_sec``; slope is the EWMA of ``d(depth)/dt``.
    * ``breach_depth = max(service_rate, min_rate) * objective_sec`` —
      the depth whose Little's-law drain time alone equals the p99
      objective.
    * breach ETA: 0 if ``L >= breach_depth``; else
      ``(breach_depth - L) / slope`` when the slope is positive; else
      None (no breach on the horizon).
    * scale-up: ETA within ``horizon_sec`` for ``up_sustain``
      consecutive ticks. Scale-down: forecast depth at the horizon
      below ``down_frac * breach_depth`` for ``down_sustain``
      consecutive ticks. Any contrary tick resets its counter — the
      hysteresis that keeps noise from flapping the fleet.
    """

    def __init__(
        self,
        objective_ms: float,
        horizon_sec: float = 30.0,
        tau_sec: float = 5.0,
        up_sustain: int = 2,
        down_sustain: int = 6,
        down_frac: float = 0.25,
        min_rate: float = 0.5,
    ):
        if objective_ms <= 0:
            raise ValueError(f"objective_ms must be > 0, got {objective_ms}")
        if horizon_sec <= 0 or tau_sec <= 0:
            raise ValueError("horizon_sec and tau_sec must be > 0")
        if up_sustain < 1 or down_sustain < 1:
            raise ValueError("sustain counts must be >= 1")
        if not (0.0 < down_frac < 1.0):
            raise ValueError(f"down_frac must be in (0, 1), got {down_frac}")
        self.objective_sec = float(objective_ms) / 1e3
        self.horizon_sec = float(horizon_sec)
        self.tau_sec = float(tau_sec)
        self.up_sustain = int(up_sustain)
        self.down_sustain = int(down_sustain)
        self.down_frac = float(down_frac)
        self.min_rate = float(min_rate)
        self._t_last: Optional[float] = None
        self._level = 0.0
        self._slope = 0.0
        self._up_count = 0
        self._down_count = 0
        # Gauge snapshot (floats assigned whole — atomic reads for the
        # summary thread; the monitor thread is the only writer).
        self.forecast_depth = 0.0
        self.breach_eta_sec: Optional[float] = None

    def step(
        self, now: float, depth: float, service_rate: float
    ) -> Optional[str]:
        """One control tick. Returns a scale hint or None."""
        depth = max(float(depth), 0.0)
        if self._t_last is None:
            self._t_last = now
            self._level = depth
            self.forecast_depth = round(depth, 2)
            return None
        dt = max(now - self._t_last, 1e-6)
        self._t_last = now
        alpha = 1.0 - math.exp(-dt / self.tau_sec)
        inst_slope = (depth - self._level) / dt
        self._level += alpha * (depth - self._level)
        self._slope += alpha * (inst_slope - self._slope)

        rate = max(float(service_rate), self.min_rate)
        breach_depth = rate * self.objective_sec
        if self._level >= breach_depth:
            eta: Optional[float] = 0.0
        elif self._slope > 1e-9:
            eta = (breach_depth - self._level) / self._slope
        else:
            eta = None
        forecast = max(self._level + self._slope * self.horizon_sec, 0.0)
        self.forecast_depth = round(forecast, 2)
        self.breach_eta_sec = None if eta is None else round(eta, 2)

        if eta is not None and eta <= self.horizon_sec:
            self._up_count += 1
            self._down_count = 0
            if self._up_count >= self.up_sustain:
                self._up_count = 0
                return "scale_up"
            return None
        self._up_count = 0
        if forecast <= self.down_frac * breach_depth:
            self._down_count += 1
            if self._down_count >= self.down_sustain:
                self._down_count = 0
                return "scale_down"
        else:
            self._down_count = 0
        return None

    def block(self) -> dict:
        """The ``forecast`` gauge block for /stats + /metrics."""
        return {
            "depth": self.forecast_depth,
            "breach_eta_sec": self.breach_eta_sec,
            "horizon_sec": self.horizon_sec,
            "objective_ms": round(self.objective_sec * 1e3, 3),
        }


def empty_forecast_block() -> dict:
    """The all-None forecast block for fleets running without an armed
    SLO p99 objective — presence means 'not armed', not 'no queue'."""
    return {
        "depth": None,
        "breach_eta_sec": None,
        "horizon_sec": None,
        "objective_ms": None,
    }
