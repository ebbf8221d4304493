"""Serving observability: latency percentiles, occupancy, padding, compiles.

The JAX package's ``serving/stats.py``, lifted (it imports nothing of JAX).
In the port, ``compiles`` counts warmed (bucket, slots, replica) entries
and the native shapes oversize fallbacks meet first (serving/warmup.py);
a bucketed shape nobody warmed shows up in the engine's
``cold_dispatches`` instead of a compile sentinel.

One :class:`ServingStats` instance rides a batcher for its whole life;
every number it reports is also a bench contract field
(``mixed_res_dir_images_per_sec``, bench.py) and the CLI's end-of-run
JSON stats block — the schema is documented in docs/SERVING.md and
pinned by tests/test_serving.py.
"""

from __future__ import annotations

import json
import random
import threading
import time
from typing import Dict, List, Optional

from waternet_tpu_torch.obs import window as obswin
from waternet_tpu_torch.obs.slo import SloEngine, WindowSample
from waternet_tpu_torch.analysis.looptrace import empty_loop_lag_block
from waternet_tpu_torch.serving.reuse import empty_cache_block

#: Latency reservoir size: percentiles are computed over at most this many
#: uniformly-sampled requests (algorithm R), so a long-lived server's
#: stats stay O(1) memory instead of one float per request forever.
LATENCY_RESERVOIR = 65536


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile on an already-sorted list (0 when empty)."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


class _ServingWindows:
    """The sliding-window view of one ServingStats instance.

    Every primitive here is self-locked (obs/window.py); the only state
    this class guards itself is the grow-only per-tier histogram dict.
    ServingStats feeds these OUTSIDE its own ``_lock`` so no
    stats-lock -> window-lock edge enters the lock-order graph.
    """

    def __init__(self, clock=None):
        self._clock = clock if clock is not None else time.monotonic
        span = obswin.DEFAULT_LONG_WINDOW_SEC
        # Latencies recorded in MILLISECONDS — the unit every quantile,
        # le-bucket, and SLO threshold in the schema speaks.
        self.latency = obswin.WindowedHistogram(span, clock=clock)
        self.queue_depth = obswin.WindowedHistogram(span, clock=clock)
        self.stream_frame = obswin.WindowedHistogram(span, clock=clock)
        self.ok = obswin.WindowedCounter(span, clock=clock)
        self.errors = obswin.WindowedCounter(span, clock=clock)
        self.shed = obswin.WindowedCounter(span, clock=clock)
        self._lock = threading.Lock()
        self._tier_latency: Dict[str, obswin.WindowedHistogram] = {}  # guarded-by: self._lock

    def now(self) -> float:
        return self._clock()

    def tier_hist(self, tier: str) -> obswin.WindowedHistogram:
        with self._lock:
            hist = self._tier_latency.get(tier)
            if hist is None:
                hist = obswin.WindowedHistogram(
                    obswin.DEFAULT_LONG_WINDOW_SEC, clock=self._clock)
                self._tier_latency[tier] = hist
        return hist

    def tier_names(self) -> List[str]:
        with self._lock:
            return sorted(self._tier_latency)

    def sample(self, span: float) -> WindowSample:
        """One window's observations in SLO-engine form."""
        return WindowSample(
            self.latency.merged(span),
            ok=self.ok.total(span),
            errors=self.errors.total(span),
            shed=self.shed.total(span),
        )

    def block(self) -> dict:
        """The ``window`` block of /stats: current-traffic quantiles and
        rates over the short window, sustained quantiles over the long,
        plus the raw le-ladder /metrics renders as a true histogram."""
        short = obswin.DEFAULT_WINDOW_SEC
        lat_short = self.latency.merged(short)
        lat_long = self.latency.merged()
        total = (self.ok.total(short) + self.errors.total(short)
                 + self.shed.total(short))
        return {
            "window_sec": short,
            "long_window_sec": obswin.DEFAULT_LONG_WINDOW_SEC,
            "latency_ms": obswin.quantile_block(lat_short),
            "latency_ms_long": obswin.quantile_block(lat_long),
            "latency_hist_ms": obswin.histogram_block(lat_long),
            "tiers": {
                t: obswin.quantile_block(self.tier_hist(t).merged(short))
                for t in self.tier_names()
            },
            "queue_depth": obswin.quantile_block(
                self.queue_depth.merged(short), digits=1),
            "stream_frame_ms": obswin.quantile_block(
                self.stream_frame.merged(short)),
            "requests_per_sec": round(self.ok.rate(short), 3),
            "shed_per_sec": round(self.shed.rate(short), 3),
            "error_rate": round(
                self.errors.total(short) / total, 6) if total else 0.0,
        }


class ServingStats:
    """Thread-safe accumulators for the serving layer.

    * per-request **latency** (submit -> result ready), reported as
      p50/p95/p99 milliseconds;
    * **queue depth** observed by the dispatcher at each batch launch;
    * **batch occupancy**: real requests / device batch slots (padding
      a partial batch up to the compiled batch size keeps the executable
      count bounded but burns slots — occupancy is that cost);
    * **padding overhead**: 1 - real pixels / padded-canvas pixels
      (the price of serving a shape from a bucket larger than it);
    * **compiles**: executables built (warmup) + any mid-serve fallback
      compile (a native-shape forward for an oversize request). A
      mid-serve compile for a *bucketed* request is a bug — the
      compile-sentinel test pins that it never happens. A replica pool
      warms ``len(buckets) x replicas`` executables;
    * **admission-control counters** (the front-door schema,
      docs/SERVING.md "Front door"): ``shed_count`` — requests refused
      at admission (queue watermark, ``QueueFull``, or an armed
      ``reject_admit`` fault); ``deadline_expired`` — requests whose
      ``X-Deadline-Ms`` budget ran out (rejected up front or dropped
      un-computed at dispatch); ``queue_depth`` — the LIVE
      outstanding-request backlog (queued, coalescing, or in flight on
      a replica), read through the probe the
      owning :class:`~waternet_tpu_torch.serving.batcher.DynamicBatcher`
      registers (0 for stats objects nothing registered on);
    * **per-replica** occupancy / mean latency / busy seconds, plus the
      aggregate **images_per_sec** (requests completed over the
      first-dispatch -> last-completion span) and **load_imbalance**
      (max over mean per-replica request count; 1.0 = perfectly even);
    * **per-tier** request/batch counters (``tiers``): quality vs fast
      traffic split under per-request tier routing (docs/SERVING.md
      "Quality tiers"). Every configured tier appears (a served-nothing
      fast tier shows zeros); batchers without a fast engine report the
      quality tier alone;
    * **fault-isolation counters** (docs/SERVING.md "Fault isolation"):
      ``retried`` — requests re-dispatched onto a surviving replica after
      their batch demonstrably failed (crash / watchdog hang / bad
      output; never double-counts a delivered result); ``downgraded`` —
      opted-in quality requests served by the fast tier under brown-out
      pressure; ``nan_outputs`` — batches the output sanity guard
      rejected (non-finite or all-zero canvas); ``quarantines`` /
      ``reintegrations`` — replica state-machine transitions, with
      ``recovery_sec_max`` the longest quarantine→reintegration span;
      ``replica_health`` — the LIVE per-tier ``{replica: state}`` map,
      read through the probe the owning batcher registers (empty for
      stats objects nothing registered on);
    * **stream counters** (``streams``, docs/SERVING.md "Streaming"):
      session opens/refusals and per-frame accounting for the
      POST ``/stream`` session layer — ``frames_dropped`` (window
      overflow, queue shed, disconnect cleanup), ``frames_out_of_budget``
      (freshness deadline ran out), ``downgrades`` (stream frames served
      by the fast tier under brown-out), ``frames_reused`` (frames
      answered from the session's cached enhanced frame by temporal
      gating — never computed; docs/SERVING.md "Temporal reuse &
      response cache"), a frame end-to-end latency reservoir (read ->
      record written; computed frames only — reused frames resolve in
      encode time and would skew the compute signal), plus the LIVE
      ``active_streams`` gauge and per-session p99 map read through the
      probe the owning
      stream manager registers (the JAX package's ``serving/streams.py``;
      the port's is ROADMAP Queue A item 6, streams)
      (0 / {} for stats objects nothing registered on);
    * the **response cache** block (``cache``): hit/miss/evict counters
      and live entry/generation gauges read through the probe the
      owning :class:`~waternet_tpu_torch.serving.reuse.ResponseCache`
      registers (an all-zeros ``enabled: false`` block for servers with
      no cache configured);
    * **sliding windows** (``latency_ms_window`` + the ``window`` block,
      docs/OBSERVABILITY.md "Windows & SLOs"): the same latency / queue
      / shed / error signals over the trailing 60 s / 300 s, so a
      post-incident scrape reports current health instead of the
      lifetime reservoir's history — and, when :meth:`arm_slo` armed an
      engine, the ``slo`` burn-rate block that grades /healthz.
    """

    def __init__(self, clock=None):
        self._lock = threading.Lock()
        # Windowed twin of the reservoirs below. Self-locked primitives,
        # fed OUTSIDE self._lock (see _ServingWindows); the clock is
        # injectable so window tests drive time without sleeping.
        self.window = _ServingWindows(clock)
        #: Armed SLO engine, or None. Assigned once by arm_slo before
        #: serving traffic (server construction), read thereafter.
        self._slo: Optional[SloEngine] = None
        # bounded reservoir sample (algorithm R)
        self._latencies_s: List[float] = []  # guarded-by: self._lock
        self._reservoir_rng = random.Random(0)  # guarded-by: self._lock
        self.requests = 0  # guarded-by: self._lock
        self.batches = 0  # guarded-by: self._lock
        self.real_slots = 0  # guarded-by: self._lock
        self.total_slots = 0  # guarded-by: self._lock
        self.real_px = 0  # guarded-by: self._lock
        self.padded_px = 0  # guarded-by: self._lock
        self.compiles = 0  # guarded-by: self._lock
        self.fallback_native = 0  # guarded-by: self._lock
        self.shed = 0  # guarded-by: self._lock
        self.deadline_expired = 0  # guarded-by: self._lock
        #: Live queue-depth gauge: a zero-arg callable the owning batcher
        #: registers (DynamicBatcher.queue_depth). Left None, the summary
        #: reports 0 — stats objects riding an ExactShapeBatcher or a bare
        #: test have no queue to report.
        self.queue_depth_probe = None
        #: Live replica-health gauge: a zero-arg callable returning the
        #: per-tier {replica_index: state} map (DynamicBatcher.health).
        #: Left None, the summary reports {} — bare stats objects have no
        #: replica pool to report on.
        self.replica_health_probe = None
        #: Live effective-coalescing-window gauge: a zero-arg callable
        #: returning {tier: eff_wait_ms} (DynamicBatcher.eff_wait_ms —
        #: the cap under --coalesce fixed, the controller's load-aware
        #: window under adaptive; docs/SERVING.md "Adaptive
        #: scheduling"). Left None, the summary reports {} — bare stats
        #: objects have no coalescing window to report.
        self.eff_wait_probe = None
        self.retried = 0  # guarded-by: self._lock
        self.downgraded = 0  # guarded-by: self._lock
        self.nan_outputs = 0  # guarded-by: self._lock
        self.quarantines = 0  # guarded-by: self._lock
        self.reintegrations = 0  # guarded-by: self._lock
        self._recovery_max_s = 0.0  # guarded-by: self._lock
        self._depth_sum = 0  # guarded-by: self._lock
        self.depth_max = 0  # guarded-by: self._lock
        self.replicas = 1  # guarded-by: self._lock
        # index -> per-replica accumulator dict
        self._rep = {}  # guarded-by: self._lock
        # tier -> {requests, batches}: populated by declare_tier (each
        # ReplicaPool registers its tier at construction) and by records;
        # a bare stats object (ExactShapeBatcher, tests) grows its tier
        # rows on first traffic.
        self._tiers = {}  # guarded-by: self._lock
        self._t_first_batch = None  # guarded-by: self._lock
        self._t_last_done = None  # guarded-by: self._lock
        # --- stream-session counters (POST /stream layer) ---
        self.streams_opened = 0  # guarded-by: self._lock
        self.streams_refused = 0  # guarded-by: self._lock
        self.stream_frames_in = 0  # guarded-by: self._lock
        self.stream_frames_delivered = 0  # guarded-by: self._lock
        self.stream_frames_dropped = 0  # guarded-by: self._lock
        self.stream_frames_out_of_budget = 0  # guarded-by: self._lock
        self.stream_frames_reused = 0  # guarded-by: self._lock
        self.stream_downgrades = 0  # guarded-by: self._lock
        # bounded reservoir sample (algorithm R)
        self._stream_lat_s: List[float] = []  # guarded-by: self._lock
        self._stream_rng = random.Random(1)  # guarded-by: self._lock
        #: Live stream gauge: a zero-arg callable the owning StreamManager
        #: registers, returning {"active_streams": int,
        #: "per_session_p99_ms": {stream_id: p99}}. Left None, the summary
        #: reports 0 / {} — most stats objects have no stream layer.
        self.stream_probe = None
        #: Live response-cache gauge: a zero-arg callable the owning
        #: ResponseCache registers (ResponseCache.counters). Left None,
        #: the summary reports the all-zeros enabled:false block — most
        #: servers run without a cache.
        self.cache_probe = None
        #: Live event-loop-lag gauge: a zero-arg callable the owning
        #: server registers when ``--obs-loop-lag`` is on (a LoopTracer
        #: with an infinite threshold wrapping Handle._run — docs/
        #: LINT.md "Asyncio rules"). Left None, the summary reports the
        #: all-zeros enabled:false block — sampling is opt-in.
        self.loop_lag_probe = None

    def declare_tier(self, tier: str) -> None:
        """Register a serving tier up front (a ReplicaPool does this at
        construction) so an idle tier still reports zeros — absence
        means 'not configured', not 'no traffic'."""
        with self._lock:
            self._tiers.setdefault(tier, {"requests": 0, "batches": 0})

    def set_replicas(self, n: int) -> None:
        """Declare the serving replica count (idle replicas must show up
        as imbalance, so every index gets an accumulator up front)."""
        with self._lock:
            self.replicas = int(n)
            for i in range(self.replicas):
                self._rep.setdefault(i, self._new_rep())

    @staticmethod
    def _new_rep() -> dict:
        return {
            "requests": 0, "batches": 0, "real_slots": 0, "total_slots": 0,
            "lat_sum_s": 0.0, "busy_s": 0.0,
        }

    def record_latency(
        self, seconds: float, replica: int = 0, tier: str = "quality"
    ) -> None:
        with self._lock:
            self.requests += 1
            rep = self._rep.setdefault(replica, self._new_rep())
            rep["requests"] += 1
            rep["lat_sum_s"] += seconds
            t = self._tiers.setdefault(tier, {"requests": 0, "batches": 0})
            t["requests"] += 1
            self._t_last_done = time.perf_counter()
            if len(self._latencies_s) < LATENCY_RESERVOIR:
                self._latencies_s.append(seconds)
            else:
                # Algorithm R: every request keeps an equal chance of
                # being in the sample, at O(1) memory for server
                # lifetimes of any length.
                j = self._reservoir_rng.randrange(self.requests)
                if j < LATENCY_RESERVOIR:
                    self._latencies_s[j] = seconds
        # Window feeds stay outside self._lock: the primitives are
        # self-locked, and nesting them under the stats lock would add
        # lock-order edges for nothing.
        ms = seconds * 1e3
        self.window.latency.record(ms)
        self.window.tier_hist(tier).record(ms)
        self.window.ok.add(1)

    def record_batch(
        self, n_real: int, n_slots: int, real_px: int, padded_px: int,
        queue_depth: int = 0, replica: int = 0, tier: str = "quality",
    ) -> None:
        with self._lock:
            self.batches += 1
            t = self._tiers.setdefault(tier, {"requests": 0, "batches": 0})
            t["batches"] += 1
            self.real_slots += n_real
            self.total_slots += n_slots
            self.real_px += real_px
            self.padded_px += padded_px
            self._depth_sum += queue_depth
            self.depth_max = max(self.depth_max, queue_depth)
            rep = self._rep.setdefault(replica, self._new_rep())
            rep["batches"] += 1
            rep["real_slots"] += n_real
            rep["total_slots"] += n_slots
            if self._t_first_batch is None:
                self._t_first_batch = time.perf_counter()
        self.window.queue_depth.record(queue_depth)

    def record_replica_busy(self, replica: int, seconds: float) -> None:
        """Launch->completion wall time of one batch on one replica —
        the device-occupancy proxy the pool reports per replica."""
        with self._lock:
            rep = self._rep.setdefault(replica, self._new_rep())
            rep["busy_s"] += seconds

    def record_compile(self, n: int = 1) -> None:
        with self._lock:
            self.compiles += n

    def record_shed(self) -> None:
        """One request refused at admission (watermark / QueueFull /
        reject_admit fault) — load that was shed, not served."""
        with self._lock:
            self.shed += 1
        self.window.shed.add(1)

    def record_deadline_expired(self) -> None:
        """One request whose deadline budget ran out before compute —
        rejected up front or dropped (not computed) at dispatch time."""
        with self._lock:
            self.deadline_expired += 1
        self.window.errors.add(1)

    def record_retry(self, n: int = 1) -> None:
        """``n`` requests re-dispatched onto a surviving replica after
        their batch demonstrably failed (crash, watchdog hang, or a
        guard-rejected output) — counted per re-dispatch, not per
        delivered result."""
        with self._lock:
            self.retried += n

    def record_downgrade(self) -> None:
        """One opted-in quality request served by the fast tier under
        brown-out pressure instead of being shed (docs/SERVING.md
        "Fault isolation")."""
        with self._lock:
            self.downgraded += 1

    def record_nan_output(self) -> None:
        """One completed batch rejected by the output sanity guard
        (non-finite values or an all-zero canvas after D2H)."""
        with self._lock:
            self.nan_outputs += 1
        self.window.errors.add(1)

    def record_quarantine(self) -> None:
        """One replica transitioned into quarantine (crash strikes or a
        watchdog-detected hang)."""
        with self._lock:
            self.quarantines += 1

    def record_reintegration(self, recovery_sec: float = 0.0) -> None:
        """One quarantined replica re-warmed and reintegrated;
        ``recovery_sec`` is its quarantine→reintegration span."""
        with self._lock:
            self.reintegrations += 1
            self._recovery_max_s = max(self._recovery_max_s, recovery_sec)

    def record_stream_open(self) -> None:
        """One stream session admitted on POST /stream."""
        with self._lock:
            self.streams_opened += 1

    def record_stream_refused(self) -> None:
        """One stream session refused at admission (503 + Retry-After:
        the third rung of the degradation ladder, or a draining server)."""
        with self._lock:
            self.streams_refused += 1

    def record_stream_frame_in(self) -> None:
        """One frame read off a stream session's upload."""
        with self._lock:
            self.stream_frames_in += 1

    def record_stream_frame_delivered(self, seconds: float) -> None:
        """One enhanced frame written back to its stream client;
        ``seconds`` is the end-to-end frame span (read -> record
        written), sampled into a bounded reservoir like request
        latency."""
        with self._lock:
            self.stream_frames_delivered += 1
            if len(self._stream_lat_s) < LATENCY_RESERVOIR:
                self._stream_lat_s.append(seconds)
            else:
                j = self._stream_rng.randrange(self.stream_frames_delivered)
                if j < LATENCY_RESERVOIR:
                    self._stream_lat_s[j] = seconds
        self.window.stream_frame.record(seconds * 1e3)

    def record_stream_drop(self, reason: str) -> None:
        """One stream frame deliberately not delivered. ``reason``
        ``"budget"`` (freshness deadline ran out) counts as
        out-of-budget; any other reason (``"window"`` overflow,
        ``"queue"`` shed, ``"disconnect"`` cleanup, ``"cancelled"``,
        ``"anchor"`` — a reuse child whose anchor never delivered)
        counts as a drop."""
        with self._lock:
            if reason == "budget":
                self.stream_frames_out_of_budget += 1
            else:
                self.stream_frames_dropped += 1

    def record_stream_frame_reused(self) -> None:
        """One stream frame answered from the session's cached enhanced
        frame by temporal gating (reuse.py) — delivered to the client
        as an ``R`` record without ever entering the batcher."""
        with self._lock:
            self.stream_frames_reused += 1

    def record_stream_downgrade(self) -> None:
        """One stream frame served by the fast tier under brown-out
        pressure (the first rung of the degradation ladder)."""
        with self._lock:
            self.stream_downgrades += 1

    def stream_latency_ms(self) -> Dict[str, float]:
        with self._lock:
            vals = sorted(self._stream_lat_s)
        return {
            "p50": round(_percentile(vals, 0.50) * 1e3, 3),
            "p99": round(_percentile(vals, 0.99) * 1e3, 3),
        }

    def record_fallback(self) -> None:
        with self._lock:
            self.fallback_native += 1
            # A fallback is a dispatch too: the throughput span must start
            # at the first dispatch of ANY kind, or an all-oversize stream
            # reports images_per_sec = 0.0 despite completing work.
            if self._t_first_batch is None:
                self._t_first_batch = time.perf_counter()

    def occupancy(self) -> float:
        with self._lock:
            return self.real_slots / self.total_slots if self.total_slots else 0.0

    def padding_overhead(self) -> float:
        with self._lock:
            return 1.0 - self.real_px / self.padded_px if self.padded_px else 0.0

    def latency_ms(self) -> Dict[str, float]:
        with self._lock:
            vals = sorted(self._latencies_s)
        return {
            "p50": round(_percentile(vals, 0.50) * 1e3, 3),
            "p95": round(_percentile(vals, 0.95) * 1e3, 3),
            "p99": round(_percentile(vals, 0.99) * 1e3, 3),
        }

    def latency_ms_window(self) -> Dict[str, float]:
        """Trailing-window latency quantiles — what the server is doing
        NOW, next to the lifetime reservoir's :meth:`latency_ms`."""
        return obswin.quantile_block(
            self.window.latency.merged(obswin.DEFAULT_WINDOW_SEC))

    def arm_slo(self, engine: SloEngine) -> None:
        """Attach an SLO engine (``--slo`` on the serving CLI). Called
        once at server construction, before traffic."""
        self._slo = engine

    def slo_state(self) -> Optional[dict]:
        """Evaluate the armed SLO engine against the current windows
        (one state-machine tick per call — scrape-driven, like every
        burn-rate evaluator). None when no engine is armed."""
        engine = self._slo
        if engine is None:
            return None
        return engine.evaluate(
            self.window.now(),
            self.window.sample(engine.short_sec),
            self.window.sample(engine.long_sec),
        )

    def images_per_sec(self) -> float:
        """Aggregate completed-requests throughput over the first-dispatch
        -> last-completion span (0.0 before any batch completes)."""
        with self._lock:
            if (
                self._t_first_batch is None
                or self._t_last_done is None
                or self._t_last_done <= self._t_first_batch
            ):
                return 0.0
            return self.requests / (self._t_last_done - self._t_first_batch)

    def load_imbalance(self) -> float:
        """max / mean per-replica request count over every configured
        replica (idle replicas count as 0, so they show up). 1.0 is a
        perfectly even pool; 1.0 by definition when nothing was served."""
        with self._lock:
            counts = [
                self._rep.get(i, {}).get("requests", 0)
                for i in range(self.replicas)
            ]
        total = sum(counts)
        if total == 0 or not counts:
            return 1.0
        return max(counts) / (total / len(counts))

    def per_replica(self) -> List[dict]:
        """Per-replica occupancy/latency rollup, by replica index."""
        with self._lock:
            reps = {i: dict(r) for i, r in self._rep.items()}
            for i in range(self.replicas):
                reps.setdefault(i, self._new_rep())
        out = []
        for i in sorted(reps):
            r = reps[i]
            out.append(
                {
                    "replica": i,
                    "requests": r["requests"],
                    "batches": r["batches"],
                    "occupancy": round(
                        r["real_slots"] / r["total_slots"], 4
                    )
                    if r["total_slots"]
                    else 0.0,
                    "latency_ms_mean": round(
                        r["lat_sum_s"] / r["requests"] * 1e3, 3
                    )
                    if r["requests"]
                    else 0.0,
                    "busy_sec": round(r["busy_s"], 3),
                }
            )
        return out

    def summary(self) -> dict:
        """The JSON stats block (docs/SERVING.md schema)."""
        with self._lock:
            batches = self.batches
            depth_mean = self._depth_sum / batches if batches else 0.0
            depth_max = self.depth_max
            requests = self.requests
            compiles = self.compiles
            fallback = self.fallback_native
            replicas = self.replicas
            shed = self.shed
            expired = self.deadline_expired
            probe = self.queue_depth_probe
            health_probe = self.replica_health_probe
            eff_wait_probe = self.eff_wait_probe
            retried = self.retried
            downgraded = self.downgraded
            nan_outputs = self.nan_outputs
            quarantines = self.quarantines
            reintegrations = self.reintegrations
            recovery_max = self._recovery_max_s
            tiers = {name: dict(c) for name, c in self._tiers.items()}
            stream_probe = self.stream_probe
            cache_probe = self.cache_probe
            loop_lag_probe = self.loop_lag_probe
            streams = {
                "opened": self.streams_opened,
                "refused": self.streams_refused,
                "frames_in": self.stream_frames_in,
                "frames_delivered": self.stream_frames_delivered,
                "frames_reused": self.stream_frames_reused,
                "frames_dropped": self.stream_frames_dropped,
                "frames_out_of_budget": self.stream_frames_out_of_budget,
                "downgrades": self.stream_downgrades,
            }
        live = (
            stream_probe()
            if stream_probe is not None
            else {"active_streams": 0, "per_session_p99_ms": {}}
        )
        streams["active_streams"] = live["active_streams"]
        streams["per_session_p99_ms"] = live["per_session_p99_ms"]
        streams["frame_latency_ms"] = self.stream_latency_ms()
        return {
            "requests": requests,
            "batches": batches,
            "latency_ms": self.latency_ms(),
            "latency_ms_window": self.latency_ms_window(),
            "batch_occupancy": round(self.occupancy(), 4),
            "padding_overhead": round(self.padding_overhead(), 4),
            "compiles": compiles,
            "fallback_native_shapes": fallback,
            "shed_count": shed,
            "deadline_expired": expired,
            "retried": retried,
            "downgraded": downgraded,
            "nan_outputs": nan_outputs,
            "quarantines": quarantines,
            "reintegrations": reintegrations,
            "recovery_sec_max": round(recovery_max, 3),
            "replica_health": (
                health_probe() if health_probe is not None else {}
            ),
            "queue_depth": int(probe()) if probe is not None else 0,
            "eff_wait_ms": (
                eff_wait_probe() if eff_wait_probe is not None else {}
            ),
            "queue_depth_mean": round(depth_mean, 2),
            "queue_depth_max": depth_max,
            "replicas": replicas,
            "images_per_sec": round(self.images_per_sec(), 2),
            "load_imbalance": round(self.load_imbalance(), 3),
            "tiers": tiers,
            "streams": streams,
            "cache": (
                cache_probe() if cache_probe is not None
                else empty_cache_block()
            ),
            "loop_lag": (
                loop_lag_probe() if loop_lag_probe is not None
                else empty_loop_lag_block()
            ),
            "per_replica": self.per_replica(),
            "window": self.window.block(),
            "slo": self.slo_state(),
        }

    def to_json(self) -> str:
        return json.dumps({"serving_stats": self.summary()})
