"""Dynamic micro-batching over shape buckets, plus the exact-shape
batcher of the inference CLI's ``--exact-shapes`` path.

The port of the JAX package's ``serving/batcher.py``, with its tier
routing: ``fast_engine`` (a :class:`~waternet_tpu_torch.inference_engine.
StudentEngine`) gets its own replica pool on the same devices and ladder,
requests pick a tier at submit, and opted-in quality requests downgrade to
the fast tier past ``downgrade_watermark``.

:class:`DynamicBatcher` is the serving engine's core: a request queue
with ``max_batch`` / ``max_wait_ms`` deadlines that coalesces concurrent
requests per bucket and hands each coalesced micro-batch to a
:class:`waternet_tpu_torch.serving.replicas.ReplicaPool` — one replica
per serving device, each with its own launch thread (host preprocess and
the enqueue on its CUDA stream) and completion thread (its one wait, on
the readback's event), so preprocessing, device compute, and readback
overlap. Results are delivered through per-request futures; consuming
them in submission order (:meth:`DynamicBatcher.map_ordered`, the CLI
path) is deterministic regardless of how requests coalesced or which
replica served them, because the forward is per-sample independent and
every replica runs the same program on the same weights (pinned in
tests/test_torch_serving.py).

Batches are padded up to the warmed ``max_batch`` slot count (last image
repeated) so every bucket is served by exactly ONE batch shape per
replica, all warmed before the first request: ``compiles`` is
``len(buckets) x replicas``. Occupancy (real requests / slots) is the
price, reported by :class:`waternet_tpu_torch.serving.stats.ServingStats`.

Worker threads run under the input pipeline's ``THREAD_PREFIX`` so the
test suite's thread-leak guard (tests/conftest.py) covers serving
shutdown bugs too.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from waternet_tpu_torch.data.pipeline import THREAD_PREFIX
from waternet_tpu_torch.obs import trace
from waternet_tpu_torch.serving.adaptive import CoalesceController
from waternet_tpu_torch.serving.bucketing import BucketLadder
from waternet_tpu_torch.serving.replicas import (
    ReplicaPool,
    SupervisionConfig,
    engine_jit_cache_size,
    resolve_replicas,
)
from waternet_tpu_torch.serving.stats import ServingStats

_CLOSE = object()
_TICK = object()


class QueueFull(RuntimeError):
    """submit() refused: the batcher's bounded request queue is at
    ``max_queue``. Under overload, admission — not memory — is the thing
    that gives; callers shed (the HTTP front door answers 429) or retry
    later instead of queueing without bound."""


class UnknownTier(ValueError):
    """submit() refused: the requested serving tier is not served by this
    batcher — either a name outside {quality, fast}, or ``fast`` on a
    batcher built without a ``fast_engine``. Raised loudly (the HTTP
    front door answers 400) instead of silently serving the wrong model:
    a tier is a quality contract, not a routing hint."""


class RequestCancelled(RuntimeError):
    """A request's caller walked away before compute (a stream session
    disconnected or drop-oldest evicted the frame, in the JAX package's
    stream layer). The owner marks the request's future with
    ``abandoned = True`` (never ``Future.cancel()``,
    which would race the replica completion thread's ``set_result``);
    the dispatcher and the re-dispatch path honor the mark by setting
    this exception instead of computing, so batch-mates from other
    sessions are untouched."""


class DeadlineExpired(RuntimeError):
    """A request's deadline ran out before its batch was computed. Raised
    from submit() when the deadline is already past at admission, and set
    on the request's future when the deadline expires while the request
    waits for dispatch — the batch is launched without it (dropped with
    ``stats.deadline_expired``, not computed)."""


class _Request:
    __slots__ = ("image", "future", "t_submit", "t_admit", "deadline",
                 "tier", "retries", "allow_downgrade", "req_id")

    def __init__(
        self,
        image: np.ndarray,
        deadline: Optional[float] = None,
        tier: str = "quality",
        allow_downgrade: bool = False,
        req_id: Optional[str] = None,
    ):
        self.image = image
        self.tier = tier
        # Correlation id stamped on every span this request touches
        # (docs/OBSERVABILITY.md); the front door echoes it in
        # ``X-Request-Id``. None = uncorrelated (library callers).
        self.req_id = req_id
        # Re-dispatch budget consumed by the replica pool when this
        # request's batch demonstrably fails (docs/SERVING.md "Fault
        # isolation"); ``allow_downgrade`` is the brown-out opt-in.
        self.retries = 0
        self.allow_downgrade = allow_downgrade
        self.future: Future = Future()
        # t_submit anchors the reported request latency; t_admit (set when
        # the dispatcher moves the request into its bucket's pending list)
        # anchors the max_wait deadline — the knob bounds time spent
        # WAITING FOR BATCHMATES, not queueing delay, which under overload
        # is capacity-bound and shared by all traffic. ``deadline`` is an
        # absolute perf_counter instant (None = no deadline): it CLAMPS
        # the coalescing wait (a lone request never waits out a window it
        # cannot afford) and, once past, drops the request at dispatch.
        self.t_submit = time.perf_counter()
        self.t_admit = self.t_submit
        self.deadline = deadline


class DynamicBatcher:
    """Coalesce an arbitrary request stream into full, bucket-shaped
    device batches behind warmed batch shapes.

    * ``max_batch`` — warmed batch-slot count per bucket;
    * ``max_wait_ms`` — the coalescing CAP: the longest a bucket's
      oldest admitted request may wait for batchmates before the
      partial batch flushes. The clock starts at dispatcher admission,
      so it bounds coalescing delay specifically — queueing delay under
      overload is capacity-bound and shared by all traffic. With
      ``coalesce="fixed"`` (the library default) the effective window
      IS the cap. With ``coalesce="adaptive"`` (the serving CLI
      default) a per-(tier, bucket) :class:`~waternet_tpu_torch.serving.
      adaptive.CoalesceController` sets the effective window inside
      [0, cap] from the EWMA arrival rate. Either way, per-request
      deadlines clamp the effective window identically;
    * ``replicas`` — serving devices (``'auto'`` = every CUDA card; 1 on
      the CPU, where an explicit N runs N replicas on the CPU). Each
      flush goes to the least-loaded replica;
      ``max_inflight_per_replica`` bounds how far any one device's launch
      side may run ahead of its readback (2 = double buffering);
    * oversize requests (no covering bucket) fall back to a per-shape
      native forward (``engine.enhance_async``) and are counted in
      ``stats.fallback_native_shapes``;
    * ``max_queue`` — bound on OUTSTANDING requests (submitted and not
      yet resolved: queued, coalescing, or in flight on a replica). At
      the bound, submit() raises :class:`QueueFull` instead of queueing
      forever; servers set it to their real watermark (docs/SERVING.md
      "Front door");
    * ``fast_engine`` — a :class:`~waternet_tpu_torch.inference_engine.
      StudentEngine` enabling per-request tier routing (docs/SERVING.md
      "Quality tiers"): the distilled CAN student gets its OWN replica
      pool on the same devices and ladder, requests pick a tier at
      submit (``tier="fast"``; default "quality" is byte-identical to a
      tier-less batcher), coalescing is per (tier, bucket), and
      unknown/unconfigured tiers raise :class:`UnknownTier`;
    * ``downgrade_watermark`` — the brown-out point: at or past this
      many outstanding quality requests, an opted-in quality request
      (``allow_downgrade``) is served by the fast tier (None disables).
    """

    def __init__(
        self,
        engine,
        ladder: BucketLadder,
        max_batch: int = 8,
        max_wait_ms: float = 10.0,
        stats: Optional[ServingStats] = None,
        warmup_verbose: bool = False,
        replicas=1,
        max_inflight_per_replica: int = 2,
        max_queue: int = 8192,
        fast_engine=None,
        tier_name: str = "quality",
        supervision: Optional[SupervisionConfig] = None,
        downgrade_watermark: Optional[int] = None,
        coalesce: str = "fixed",
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if downgrade_watermark is not None and downgrade_watermark < 1:
            raise ValueError(
                f"downgrade_watermark must be >= 1 (or None to disable "
                f"brown-out downgrades), got {downgrade_watermark}"
            )
        # ``tier_name`` labels the PRIMARY engine's pool in the stats —
        # "fast" when the CLI serves a StudentEngine alone (--tier fast).
        # A two-tier batcher keeps the primary as "quality".
        if tier_name not in ("quality", "fast"):
            raise ValueError(
                f"tier_name must be 'quality' or 'fast', got {tier_name!r}"
            )
        if fast_engine is not None and tier_name != "quality":
            raise ValueError(
                "a two-tier batcher's primary engine IS the quality tier; "
                "tier_name overrides are for single-engine batchers"
            )
        self._default_tier = tier_name
        self.engine = engine
        self.max_batch = int(max_batch)
        data_shards = engine.data_shards
        if self.max_batch % data_shards:
            # The warmed batch shape is fixed, and a data-sharded engine
            # needs equal per-shard slices: round the slot count up.
            self.max_batch += data_shards - self.max_batch % data_shards
        self.ladder = ladder = fit_ladder_to_engine(ladder, engine)
        self.max_wait_s = float(max_wait_ms) / 1e3
        # Effective-window authority: fixed mode returns the cap from
        # every read; adaptive mode shrinks/grows inside [0, cap] from
        # the EWMA arrival rate (serving/adaptive.py). Validates the mode
        # name loudly here, at construction.
        self._coalesce = CoalesceController(self.max_wait_s, mode=coalesce)
        self.stats = stats if stats is not None else ServingStats()
        # No request ever meets a cold shape: the whole per-replica grid
        # is warmed before the first submit is accepted.
        self.supervision = (
            supervision if supervision is not None else SupervisionConfig()
        )
        # A plain attribute read at submit: /admin/policy moves it at run
        # time, and the next submit sees the new value.
        self.downgrade_watermark = downgrade_watermark
        self._pool = ReplicaPool(
            engine, ladder, [self.max_batch],
            n_replicas=resolve_replicas(replicas, engine),
            max_inflight_per_replica=max_inflight_per_replica,
            stats=self.stats, warmup_verbose=warmup_verbose,
            tier=self._default_tier, supervision=self.supervision,
        )
        # Per-request tier routing: ``fast_engine`` gets its OWN replica
        # pool on the same devices, ladder and slot count — its own warmed
        # batch shapes, launch/completion threads and per-tier stats —
        # while quality traffic flows through the pool above
        # byte-identically to a tier-less batcher.
        self._pools = {self._default_tier: self._pool}
        if fast_engine is not None:
            self._pools["fast"] = ReplicaPool(
                fast_engine, ladder, [self.max_batch],
                n_replicas=self._pool.n_replicas,
                max_inflight_per_replica=max_inflight_per_replica,
                stats=self.stats, warmup_verbose=warmup_verbose,
                tier="fast", supervision=self.supervision,
            )
        self._requests: queue.Queue = queue.Queue()
        self._closed = False  # guarded-by: self._submit_lock
        self.max_queue = int(max_queue)
        # Per-tier outstanding counts: the quality tier's backlog is the
        # brown-out pressure gauge.
        self._tier_backlog = {t: 0 for t in self._pools}  # guarded-by: self._submit_lock
        # Outstanding-request count: submitted and not yet RESOLVED —
        # queued, coalescing, or in flight on a replica. This is the
        # admission-control gauge and the QueueFull bound: the
        # dispatcher itself only routes, so a bound on the undispatched
        # slice alone would never trip under overload — what grows
        # without limit is work admitted faster than devices finish it,
        # and every such request holds host RAM until its future
        # resolves. Decremented by a future done-callback, which covers
        # every resolution path (result, error, deadline drop).
        self._backlog = 0  # guarded-by: self._submit_lock
        self.stats.queue_depth_probe = self.queue_depth
        self.stats.replica_health_probe = self.health
        self.stats.eff_wait_probe = self._coalesce.eff_wait_ms
        # Makes the closed-check + enqueue atomic vs close(): without it a
        # racing submit() could land its request BEHIND the _CLOSE
        # sentinel, where the dispatcher never looks — the caller would
        # block forever on a future that cannot resolve.
        self._submit_lock = threading.Lock()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop,
            name=f"{THREAD_PREFIX}-serve-dispatch",
            daemon=True,
        )
        self._dispatcher.start()

    @property
    def coalesce_mode(self) -> str:
        """The configured coalescing mode: "fixed" (constant hold at the
        ``max_wait_ms`` cap) or "adaptive" (load-aware window inside
        [0, cap]) — surfaced in the server banner and /stats config."""
        return self._coalesce.mode

    def eff_wait_ms(self) -> dict:
        """Live per-tier effective coalescing window (ms) — the
        ``eff_wait_ms`` gauge of /stats and /metrics."""
        return self._coalesce.eff_wait_ms()

    @property
    def n_replicas(self) -> int:
        return self._pool.n_replicas

    @property
    def tiers(self) -> Tuple[str, ...]:
        """The tier names this batcher serves ("fast" iff a
        ``fast_engine`` was configured or the primary is named so)."""
        return tuple(sorted(self._pools))

    # -- public API ----------------------------------------------------

    def submit(
        self,
        image: np.ndarray,
        deadline: Optional[float] = None,
        tier: Optional[str] = None,
        allow_downgrade: bool = False,
        request_id: Optional[str] = None,
    ) -> Future:
        """Queue one (H, W, 3) uint8 image; resolves to its enhanced
        native-shape uint8 array. Thread-safe.

        ``request_id`` is an optional correlation id: when tracing is
        armed (waternet_tpu_torch/obs) every span this request touches —
        queue wait, coalesce, device, re-dispatch hop — carries it.

        ``deadline`` is an absolute ``time.perf_counter()`` instant.
        Already past at admission -> :class:`DeadlineExpired` here;
        still pending when it expires -> the future gets
        :class:`DeadlineExpired` and the batch launches without the
        request. Either way ``stats.deadline_expired`` counts it. Raises
        :class:`QueueFull` at the ``max_queue`` bound.

        ``tier`` (None = the batcher's primary tier) names the serving
        model: "quality" is the full WaterNet pipeline, "fast" the CAN
        student pool; any other name, or a tier this batcher does not
        serve, raises :class:`UnknownTier`.

        ``allow_downgrade`` is the brown-out opt-in: when the quality
        tier's outstanding count sits at/past ``downgrade_watermark`` and
        a fast pool is configured, an opted-in quality request is served
        by the fast tier (counted in ``stats.downgraded``). Requests that
        did not opt in are never downgraded. The returned future carries
        the tier that serves it as ``.tier``.
        """
        tier = self._default_tier if tier is None else str(tier).lower()
        if tier not in ("quality", "fast"):
            raise UnknownTier(
                f"unknown tier {tier!r}: valid tiers are 'quality' and "
                "'fast'"
            )
        if tier not in self._pools:
            hint = (
                " — the fast tier needs a student engine (server: "
                "--student-weights)"
                if tier == "fast"
                else ""
            )
            raise UnknownTier(
                f"tier {tier!r} is not configured on this batcher "
                f"(serving: {', '.join(sorted(self._pools))}){hint}"
            )
        if image.ndim != 3 or image.shape[-1] != 3:
            raise ValueError(
                f"expected one (H, W, 3) image, got shape {image.shape}"
            )
        if image.dtype != np.uint8:
            # Validated HERE, loudly: a non-uint8 image would raise at
            # LAUNCH instead, where the supervised pool cannot tell a
            # poison-pill request from a sick device — one bad submit
            # could strike (and cascade-quarantine) healthy replicas.
            raise ValueError(
                f"expected a uint8 image, got dtype {image.dtype} (the "
                "serving contract is (H, W, 3) uint8)"
            )
        if deadline is not None and deadline <= time.perf_counter():
            self.stats.record_deadline_expired()
            raise DeadlineExpired(
                "deadline already past at admission (the coalescing window "
                "plus compute cannot finish in negative time)"
            )
        req = _Request(
            image, deadline=deadline, tier=tier,
            allow_downgrade=allow_downgrade, req_id=request_id,
        )
        # The callback reads the served tier off the FUTURE (set below,
        # before enqueue), not off a captured request: Future keeps its
        # callbacks after resolution, so a req-capturing closure would
        # pin every input image for as long as the caller holds the
        # future.
        req.future.add_done_callback(self._on_request_resolved)
        downgraded = False
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("DynamicBatcher is closed")
            if self._backlog >= self.max_queue:
                self.stats.record_shed()
                raise QueueFull(
                    f"{self._backlog} requests outstanding, max_queue="
                    f"{self.max_queue}: shedding instead of queueing forever"
                )
            if (
                allow_downgrade
                and req.tier == "quality"
                and "fast" in self._pools
                and self.downgrade_watermark is not None
                and self._tier_backlog.get("quality", 0)
                >= self.downgrade_watermark
            ):
                # Brown-out: the quality queue is saturated and the
                # request opted in — a fast-tier answer now beats a 429.
                req.tier = "fast"
                downgraded = True
            req.future.tier = req.tier  # the tier that will actually serve
            self._backlog += 1
            self._tier_backlog[req.tier] = self._tier_backlog.get(req.tier, 0) + 1
            self._requests.put(req)
        if downgraded:
            self.stats.record_downgrade()
        return req.future

    def _on_request_resolved(self, future) -> None:
        """Done-callback on every request future: runs on whichever
        thread resolves it (replica completion, error path, deadline
        drop), so the outstanding counts — global and per-tier — can
        never leak. The tier rides the future itself."""
        tier = getattr(future, "tier", None)
        with self._submit_lock:
            self._backlog -= 1
            if tier is not None:
                self._tier_backlog[tier] = self._tier_backlog.get(tier, 0) - 1

    def queue_depth(self) -> int:
        """Live outstanding-request count (queued + coalescing + in
        flight) — the admission-control gauge the HTTP front door's
        watermark reads, exported as ``queue_depth`` in
        ``stats.summary()``."""
        with self._submit_lock:
            return self._backlog

    def tier_depth(self, tier: str) -> int:
        """Live outstanding-request count for one tier — the quality
        tier's is the brown-out pressure gauge."""
        with self._submit_lock:
            return self._tier_backlog.get(tier, 0)

    def health(self) -> dict:
        """Live per-tier replica health map, ``{tier: {index: state}}``
        (docs/SERVING.md "Fault isolation") — what ``/healthz`` degrades
        on and ``stats.summary()['replica_health']`` reports."""
        return {t: pool.health() for t, pool in self._pools.items()}

    def set_params(self, params) -> None:
        """Hot weight reload of the QUALITY tier: atomically swap every
        replica's weights between batches (in-flight batches keep the
        model they were launched with; no request is dropped). The caller
        validates names/shapes/dtypes first; same-shaped weights meet no
        new batch shape, so a reload causes no cold dispatch. The fast
        tier keeps its own student (restart to swap a student)."""
        self._pool.set_params(params)

    def map_ordered(
        self, images: Iterable[np.ndarray], tier: Optional[str] = None
    ) -> List[np.ndarray]:
        """Submit everything, then collect results in submission order —
        the deterministic whole-stream entry point (bench A/B uses it)."""
        futures = [self.submit(im, tier=tier) for im in images]
        self.drain()
        return [f.result() for f in futures]

    def drain(self) -> None:
        """Flush all pending partial batches without closing: everything
        submitted before the call resolves without waiting out deadlines."""
        self._requests.put(_TICK)

    def close(self) -> None:
        """Flush pending requests, stop the dispatcher and every
        replica's workers, join them all. Idempotent; safe from
        ``finally``."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._requests.put(_CLOSE)
        # The dispatcher's finally closes the pool (draining every
        # replica's queued work and joining its threads), so one join
        # covers the whole serving stack.
        self._dispatcher.join(timeout=120.0)

    def __enter__(self) -> "DynamicBatcher":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -- dispatcher ----------------------------------------------------

    def _dispatch_loop(self) -> None:
        pending: dict = {}  # (tier, bucket) -> [requests, FIFO]

        def flush_all():
            for key in list(pending):
                self._flush(key, pending.pop(key))

        try:
            while True:
                timeout = self._next_deadline(pending)
                try:
                    item = self._requests.get(timeout=timeout)
                except queue.Empty:
                    item = None  # a deadline expired while the queue was idle
                if item is _CLOSE:
                    flush_all()
                    break
                if item is _TICK:
                    flush_all()
                    continue
                if item is not None:
                    self._admit(item, pending)
                    self._sweep(pending)
                # Coalescing-friendly burst drain: admit everything that
                # was already queued when this cycle started, so a burst
                # forms full batches instead of deadline-split fragments
                # (burst admits are microseconds apart, far inside any
                # real wait budget, so the per-admit sweep stays quiet).
                # BOUNDED by the qsize snapshot — items arriving during
                # the drain's inline flushes wait for the next cycle.
                # Sweeping after every admit means sustained traffic in
                # OTHER buckets cannot hold a sparse bucket's request
                # past its wait budget by more than ~one batch dispatch.
                closing = False
                for _ in range(self._requests.qsize()):
                    try:
                        nxt = self._requests.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is _CLOSE:
                        closing = True
                        break
                    if nxt is _TICK:
                        flush_all()
                        continue
                    self._admit(nxt, pending)
                    self._sweep(pending)
                if closing:
                    flush_all()
                    break
                self._sweep(pending)  # idle-queue cycles: deadlines fire here
        finally:
            for pool in self._pools.values():
                pool.close()

    def _admit(self, req: _Request, pending: dict) -> None:
        req.t_admit = time.perf_counter()
        if trace.enabled():
            # Queue wait: submit -> dispatcher admission, from timestamps
            # the batcher already keeps — arming adds no clock reads.
            trace.record_span(
                "queue_wait", "serving", req.t_submit, req.t_admit,
                args={"request_id": req.req_id, "tier": req.tier},
            )
        h, w = req.image.shape[:2]
        bucket = self.ladder.bucket_for(h, w)
        # Coalescing is per (tier, bucket): tiers never share a device
        # batch — a micro-batch runs ONE model on one executable. The
        # controller sees every admission: its arrival-rate estimate is
        # what sizes the NEXT effective window for this key.
        key = (req.tier, bucket)
        self._coalesce.observe_arrival(req.tier, bucket, req.t_admit)
        pending.setdefault(key, []).append(req)
        if bucket is None or len(pending[key]) >= self.max_batch:
            self._flush(key, pending.pop(key))

    def _eff_deadline(self, req: _Request, window_s: float) -> float:
        """When this request's bucket must flush on its account: the
        effective coalescing budget (``window_s`` — the cap under fixed
        mode, the controller's load-aware window under adaptive),
        CLAMPED by the request's own deadline — a request with 5 ms
        left never waits out a 20 ms window it cannot afford."""
        t = req.t_admit + window_s
        if req.deadline is not None:
            t = min(t, req.deadline)
        return t

    def _window_for(self, key, now: float, busy_cache: dict) -> float:
        """The effective coalescing window for one (tier, bucket): the
        controller's load-aware window, EXTENDED back to the cap while
        every replica of the tier is busy. The extension is
        work-conserving: with no idle replica, flushing a partial bucket
        early cannot start its compute any sooner — the batch would sit
        in the pool queue while its (slot-padded, so full-price) partial
        fill is locked in. Held buckets still flush the instant they
        fill (``_admit``) and each request's own deadline still clamps
        in ``_eff_deadline``. Fixed mode already sits at the cap, so the
        probe is skipped and behavior is bit-for-bit the historical
        hold. ``busy_cache`` memoizes one pool probe per tier per
        dispatcher pass."""
        tier, bucket = key
        w = self._coalesce.window_s(tier, bucket, now)
        if w >= self.max_wait_s:
            return w
        busy = busy_cache.get(tier)
        if busy is None:
            busy = not self._pools[tier].has_idle_replica()
            busy_cache[tier] = busy
        return self.max_wait_s if busy else w

    def _sweep(self, pending: dict) -> None:
        """Flush every bucket holding a request whose effective deadline
        (coalescing budget clamped by its own deadline) has passed
        (cheap: O(pending requests) clock checks, one controller read
        per pending bucket, at most one pool-idleness probe per tier)."""
        now = time.perf_counter()
        busy_cache: dict = {}
        for key in list(pending):
            reqs = pending[key]
            if not reqs:
                continue
            w = self._window_for(key, now, busy_cache)
            if min(self._eff_deadline(r, w) for r in reqs) <= now:
                self._flush(key, pending.pop(key))

    def _next_deadline(self, pending: dict) -> Optional[float]:
        soonest = None
        now = time.perf_counter()
        busy_cache: dict = {}
        for key, reqs in pending.items():
            if not reqs:
                continue
            w = self._window_for(key, now, busy_cache)
            for r in reqs:
                t = self._eff_deadline(r, w)
                soonest = t if soonest is None else min(soonest, t)
        if soonest is None:
            return None  # idle: block until the next request
        return max(0.0, soonest - now)

    def _flush(self, key, reqs: List[_Request]) -> None:
        """Hand one coalesced micro-batch to its tier's least-loaded
        replica. Host preprocessing, the async device launch, and the D2H
        sync all happen on that replica's own threads (serving/replicas.py),
        so this dispatcher only ever routes — a slow readback on one device
        cannot delay coalescing or launches for the others. Requests whose
        deadline has already passed are dropped here with a counter, not
        computed: a response nobody is waiting for is pure wasted device
        time under exactly the overload that made it late."""
        tier, bucket = key
        if not reqs:
            return
        now = time.perf_counter()
        live: List[_Request] = []
        for r in reqs:
            if getattr(r.future, "abandoned", False):
                # Caller walked away (stream disconnect / drop-oldest):
                # the dispatcher solely owns un-dispatched pending
                # requests, so resolving here cannot race a replica.
                if not r.future.done():
                    r.future.set_exception(
                        RequestCancelled(
                            "request abandoned by its caller; "
                            "dropped un-computed at dispatch"
                        )
                    )
            elif r.deadline is not None and r.deadline <= now:
                self.stats.record_deadline_expired()
                if not r.future.done():
                    r.future.set_exception(
                        DeadlineExpired(
                            "deadline expired while waiting for dispatch; "
                            "request dropped un-computed"
                        )
                    )
            else:
                live.append(r)
        if bucket is not None and live:
            # Occupancy feedback: what this flush's fill looked like —
            # the controller's EWMA gauge (bench serve_adaptive reports
            # it). Fallback natives (bucket None) always flush alone
            # and would only skew the gauge.
            self._coalesce.observe_flush(tier, len(live) / self.max_batch)
        if trace.enabled():
            # Coalesce: admission -> flush, per surviving request, each
            # carrying the wait it actually paid (eff_wait_ms — the
            # adaptive win is visible per request in traces); the
            # dropped ones get instants so a trace explains the gap.
            for r in live:
                trace.record_span(
                    "coalesce", "serving", r.t_admit, now,
                    args={"request_id": r.req_id, "tier": tier,
                          "bucket": str(bucket),
                          "eff_wait_ms": round((now - r.t_admit) * 1e3, 3)},
                )
            for r in reqs:
                if r not in live and r.future.done():
                    trace.record_instant(
                        "request_dropped", "serving", t=now,
                        args={"request_id": r.req_id, "tier": tier},
                    )
        if not live:
            return
        try:
            self._pools[tier].dispatch(
                bucket, live, queue_depth=self._requests.qsize()
            )
        except BaseException as err:
            for r in live:
                if not r.future.done():
                    r.future.set_exception(err)


class ExactShapeBatcher:
    """The per-shape grouping of the CLI's ``--exact-shapes`` path:
    consecutive same-shaped images stack into device batches of up to
    ``batch_size``; a shape change flushes the pending batch; every new
    batch shape meets the device cold (counted as a compile through the
    engine's shape count). The A/B baseline the bench line measures
    bucketing against.
    """

    def __init__(self, engine, batch_size: int, stats: Optional[ServingStats] = None):
        self.engine = engine
        self.batch_size = int(batch_size)
        self.stats = stats if stats is not None else ServingStats()
        self._pending: List[Tuple[object, np.ndarray, float]] = []

    def push(self, key, image: np.ndarray) -> List[Tuple[object, np.ndarray]]:
        """Add one image; returns any (key, enhanced) results this push
        flushed, in submission order (possibly two groups: the
        shape-change flush then the size-cap flush)."""
        flushed: List[Tuple[object, np.ndarray]] = []
        if self._pending and image.shape != self._pending[0][1].shape:
            flushed.extend(self.flush())
        self._pending.append((key, image, time.perf_counter()))
        if len(self._pending) >= self.batch_size:
            flushed.extend(self.flush())
        return flushed

    def flush(self) -> List[Tuple[object, np.ndarray]]:
        if not self._pending:
            return []
        images = [im for _, im, _ in self._pending]
        before = engine_jit_cache_size(self.engine)
        outs = self.engine.enhance(np.stack(images))
        grew = engine_jit_cache_size(self.engine) - before
        if grew > 0:
            self.stats.record_compile(grew)
        h, w = images[0].shape[:2]
        self.stats.record_batch(
            n_real=len(images),
            n_slots=self.batch_size,
            real_px=len(images) * h * w,
            padded_px=len(images) * h * w,  # exact shapes: zero padding
        )
        t_done = time.perf_counter()
        results = [(k, out) for (k, _, _), out in zip(self._pending, outs)]
        # Latency is push -> result ready, the same submit-anchored metric
        # DynamicBatcher records — the two batchers' stats are comparable.
        for _, _, t_push in self._pending:
            self.stats.record_latency(t_done - t_push)
        self._pending.clear()
        return results


def fit_ladder_to_engine(ladder: BucketLadder, engine) -> BucketLadder:
    """Round a ladder's bucket heights up to what the engine can serve.

    Spatially sharded engines split H over ``spatial_shards`` devices and
    need every slab to hold at least ``2 * HALO`` rows, so each bucket
    height rounds up to the next multiple of the shard count with a
    ``2 * HALO * shards`` floor; rounding *up* keeps every shape the
    original ladder covered. Unsharded engines (and batch-sharded ones,
    whose constraint is on the slot count, not the canvas) pass through
    untouched."""
    shards = engine.spatial_shards
    if shards <= 1:
        return ladder
    from waternet_tpu_torch.parallel.spatial import HALO

    min_h = 2 * HALO * shards
    return BucketLadder(
        {(max(-(-bh // shards) * shards, min_h), bw) for bh, bw in ladder}
    )


def resolve_ladder(
    spec: str,
    shapes: Optional[Sequence[Tuple[int, int]]] = None,
    max_buckets: int = 3,
) -> BucketLadder:
    """CLI-facing ladder resolution: ``"auto"`` derives from the scanned
    ``shapes`` (falling back to the default square ladder when no shapes
    are known), anything else parses as an explicit bucket list."""
    from waternet_tpu_torch.serving.bucketing import derive_buckets, parse_buckets

    if spec.strip().lower() == "auto":
        if shapes:
            return derive_buckets(shapes, max_buckets=max_buckets)
        return parse_buckets("256,512,1080x1920")
    return parse_buckets(spec)
