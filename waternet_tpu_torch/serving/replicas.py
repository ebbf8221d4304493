"""Multi-device serving scale-out: a pool of per-device replicas under the
dynamic batcher, with per-replica supervision and fault isolation
(docs/SERVING.md "Replica pool" and "Fault isolation").

The port of the JAX package's ``serving/replicas.py``: the same pool, the
same health machine and the same claim protocol, on torch devices.

WaterNet's serving forward has no cross-request state, so images/sec
should scale with the device count once nothing serializes between
devices. The pool places **a copy of the weights and the warmed (bucket,
max_batch) grid on every serving device** and gives each replica its own
launch and completion threads:

* the launch thread runs host preprocessing and enqueues the upload, the
  forward and the pinned readback on the replica's **own CUDA stream**,
  then records an event;
* the completion thread waits on **that event** (never on
  ``torch.cuda.synchronize()``, which would also wait for the other
  batch in flight) and reads the result from pinned memory.

So host preprocessing for replica *i*'s next batch, device compute, and
the readback all overlap. The batcher's dispatcher routes each coalesced
micro-batch to the **least-loaded available replica** (fewest outstanding
batches, ties to the lowest index), and ``max_inflight_per_replica``
keeps every device double-buffered without letting one run away with the
queue.

**Replicas and devices.** On CUDA, ``--serve-replicas auto`` is
``torch.cuda.device_count()`` and more replicas than cards raises. A CPU
engine may run N replicas, all on ``torch.device("cpu")``, each with its
own copy of the weights: that is how the CPU tests drive dispatch,
quarantine, re-dispatch and the output guard. ``auto`` on the CPU is 1.

**Fault isolation.** One sick device must not take the pool down with
it, so every replica runs a health state machine

    healthy -> suspect -> quarantined -> rewarming -> (reintegrated)

driven by a supervisor thread with per-batch **watchdog deadlines**:

* a batch that *raises* marks its replica ``suspect`` and its requests
  re-dispatch onto surviving replicas (bounded per-request retries); the
  supervisor then quarantines the suspect;
* a batch that *hangs* past ``watchdog_sec`` is detected by the
  supervisor, its replica quarantined with fresh worker threads (the
  wedged ones are retired: they cannot be interrupted, only replaced),
  and its stranded requests re-dispatched;
* a completed batch whose host array fails the **output sanity guard**
  (non-finite values / all-zero canvas) is treated exactly like a crash:
  counted (``nan_outputs``) and retried;
* a quarantined replica is **re-warmed** (a probe batch through its
  warmed callables, a shape already warm, watchdog-guarded) and
  reintegrated on success, with exponential backoff on probe failure.

Retries are **byte-identical**: every replica runs the same program on
the same weights, and a request's output never depends on its batchmates
(the batch is always padded to the warmed slot count, so the shape never
changes). A batch is retried only when it *demonstrably* failed: a claim
protocol under the pool lock guarantees exactly one delivery per request.

Oversize requests (no covering bucket) take the native-shape fallback
(``engine.enhance_async``) on the engine's device, routed to the
lowest-index available replica, with the shape-count probe serialized
under a pool-level lock.

All worker threads run under the input pipeline's ``THREAD_PREFIX`` so
the test suite's thread-leak guard covers pool shutdown too, and
:meth:`ReplicaPool.close` reports any thread that fails to join.
"""

from __future__ import annotations

import dataclasses
import queue
import sys
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import contextlib

import numpy as np
import torch

from waternet_tpu_torch.data.pipeline import THREAD_PREFIX
from waternet_tpu_torch.obs import trace
from waternet_tpu_torch.resilience import faults
from waternet_tpu_torch.serving.bucketing import Bucket, BucketLadder
from waternet_tpu_torch.serving.stats import ServingStats
from waternet_tpu_torch.serving.warmup import probe_image, warmup
from waternet_tpu_torch.utils.tensor import finish_readback, start_readback, ten2arr

_CLOSE = object()

#: Replica health states (docs/SERVING.md "Fault isolation").
HEALTHY = "healthy"
SUSPECT = "suspect"
QUARANTINED = "quarantined"
REWARMING = "rewarming"

#: States in which a replica accepts new work. A suspect replica keeps
#: serving until the supervisor's next scan quarantines it — the window
#: is one scan interval, and claims keep any double-delivery impossible.
AVAILABLE_STATES = (HEALTHY, SUSPECT)


class ReplicaUnavailable(RuntimeError):
    """No replica in an available state could take the work: everything
    is quarantined (or the quarantined replica was the only one and its
    requests exhausted their retries). The HTTP front door answers 503 —
    and ``/healthz`` has been reporting the pool unhealthy since the
    last quarantine."""


class BadOutput(RuntimeError):
    """A completed batch failed the output sanity guard (non-finite
    values or an all-zero canvas after D2H) more times than the retry
    budget allows."""


@dataclasses.dataclass
class SupervisionConfig:
    """Knobs for the replica supervisor (docs/SERVING.md "Fault
    isolation"). The defaults are production-shaped: a generous watchdog
    (real batches finish in milliseconds; 30 s only ever fires on a
    genuinely wedged device) and a small re-warm backoff so a transient
    fault costs milliseconds of capacity, not minutes."""

    #: Seconds a dispatched batch may stay in flight (dequeue -> host
    #: delivery) before its replica is declared hung and quarantined.
    #: None disables the watchdog (crash isolation still works).
    watchdog_sec: Optional[float] = 30.0
    #: Watchdog for OVERSIZE FALLBACK launches, separate because their
    #: launch meets a new shape cold (cuDNN's plan, fresh allocator
    #: blocks; an XLA compile in the JAX package) — longer than a
    #: bucketed-batch watchdog should allow. None (the default) exempts
    #: fallbacks entirely (a wedged fallback strands its launcher and
    #: whatever is queued behind it); operators whose oversize traffic
    #: matters set it ABOVE their slowest native-shape first call.
    fallback_watchdog_sec: Optional[float] = None
    #: Per-request bound on re-dispatches after demonstrable batch
    #: failures; past it the request's future gets the causing error.
    max_retries: int = 2
    #: Delay before the first re-warm probe of a quarantined replica
    #: (doubles per failed probe up to ``max_rewarm_backoff_sec``).
    rewarm_backoff_sec: float = 0.05
    max_rewarm_backoff_sec: float = 5.0
    #: Supervisor scan cadence (watchdog resolution).
    scan_interval_sec: float = 0.02
    #: Check every completed batch for non-finite / all-zero output.
    output_guard: bool = True


class _Inflight:
    """One dispatched batch under watchdog supervision. ``state`` moves
    ``live -> claimed`` (a worker delivered or errored it) or ``live ->
    aborted`` (the supervisor declared it failed and re-dispatched its
    requests); the transition happens exactly once, under the pool lock
    — the single-delivery guarantee."""

    __slots__ = ("replica", "bucket", "reqs", "deadline", "state",
                 "probe", "t0")

    def __init__(self, replica, bucket, reqs, deadline, probe):
        self.replica = replica
        self.bucket = bucket
        self.reqs = reqs
        self.deadline = deadline
        self.state = "live"
        self.probe = probe
        self.t0 = None


class _ProbeRequest:
    """The single request of a re-warm probe batch: same attribute shape
    as the batcher's requests, never counted in serving stats."""

    __slots__ = ("image", "future", "t_submit", "retries", "tier")

    def __init__(self, image):
        self.image = image
        self.future = Future()
        self.t_submit = time.perf_counter()
        self.retries = 0
        self.tier = None


def engine_jit_cache_size(engine) -> int:
    """How many ``(path, batch shape, device)`` keys the engine has run
    (:meth:`InferenceEngine.shape_cache_size <waternet_tpu_torch.
    inference_engine.InferenceEngine.shape_cache_size>`): the port's
    counterpart of the JAX engine's jit cache sizes. Its growth across a
    call is the number of shapes first met there, which the serving layer
    counts as compiles (the oversize fallback's new native shapes)."""
    return engine.shape_cache_size()


def _cuda_engine(engine) -> bool:
    return engine.device.type == "cuda"


def resolve_replicas(spec, engine=None) -> int:
    """``'auto'`` / ``N`` / ``None`` -> a concrete replica count.

    On CUDA, ``auto`` (and None/empty) means every visible card
    (``torch.cuda.device_count()``), and an N above that raises. A CPU
    engine resolves ``auto`` to 1 and may run any N, every replica on
    ``torch.device("cpu")`` (the CPU tests' multi-replica pools). Sharded
    engines resolve ``auto`` to 1 (their one forward already spans the
    mesh) and refuse an explicit N above 1."""
    cuda = engine is not None and _cuda_engine(engine)
    sharded = engine is not None and engine.sharded
    text = "auto" if spec is None else str(spec).strip().lower()
    if text in ("", "auto"):
        if sharded:
            return 1
        return max(1, torch.cuda.device_count()) if cuda else 1
    try:
        n = int(text)
    except ValueError:
        raise ValueError(
            f"--serve-replicas must be 'auto' or a positive integer, got "
            f"{spec!r}"
        ) from None
    if n < 1:
        raise ValueError(f"--serve-replicas must be >= 1, got {n}")
    if cuda and n > torch.cuda.device_count():
        raise ValueError(
            f"--serve-replicas {n} exceeds the {torch.cuda.device_count()} "
            "CUDA device(s)"
        )
    if sharded and n != 1:
        raise ValueError(
            f"--serve-replicas {n} conflicts with a sharded engine "
            f"(data_shards={engine.data_shards}, spatial_shards={engine.spatial_shards}): "
            "its forward spans its mesh as ONE replica"
        )
    return n


class _Replica:
    """One serving device: its copy of the weights, its warmed grid of
    serving callables, a work queue feeding a launch thread (host
    preprocess + enqueue on the replica's CUDA stream), a bounded
    in-flight queue feeding a completion thread (the replica's one wait,
    on the readback's event) — and a health state the supervisor drives.
    Worker threads are per-*generation*: a quarantine retires the current
    pair (wedged threads cannot be interrupted, only replaced) and spawns
    a fresh pair on fresh queues."""

    def __init__(self, pool: "ReplicaPool", index: int, device):
        self.pool = pool
        self.index = index
        self.device = device
        self.params = pool.engine.replica_params(device)
        self.executables: Dict[Tuple[Bucket, int], object] = {}
        # The replica's own stream on CUDA: its uploads, forwards and
        # readbacks queue there, behind nothing of another replica's.
        dev = pool.engine._dev(device)
        self.stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        self.outstanding = 0  # batches dispatched, not yet resolved (pool lock)
        self.state = HEALTHY
        self.gen = 0
        self.crashes = 0
        self.hangs = 0
        self.bad_outputs = 0
        self.quarantines = 0
        self.reintegrations = 0
        self._quarantined_at: Optional[float] = None
        self._rewarm_backoff = 0.0
        self._next_rewarm_at = 0.0
        self._probe: Optional[Future] = None
        self._spawn()

    def _spawn(self) -> None:
        """Fresh queues + worker threads for the current generation (not
        started — callers start them; respawn() starts immediately)."""
        self.work: queue.Queue = queue.Queue()
        # Launch at most max_inflight batches ahead of this replica's
        # completion sync: the device stays double-buffered, and a slow
        # D2H cannot pile unbounded device allocations behind it.
        self.inflight: queue.Queue = queue.Queue(maxsize=self.pool.max_inflight)
        suffix = f"-{self.index}" if self.gen == 0 else f"-{self.index}g{self.gen}"
        self._launcher = threading.Thread(
            target=self._launch_loop,
            args=(self.work, self.inflight, self.gen),
            name=f"{THREAD_PREFIX}-serve-launch{suffix}",
            daemon=True,
        )
        self._completer = threading.Thread(
            target=self._complete_loop,
            args=(self.inflight,),
            name=f"{THREAD_PREFIX}-serve-complete{suffix}",
            daemon=True,
        )

    def start(self) -> None:
        self._launcher.start()
        self._completer.start()

    def respawn(self):
        """Retire the current worker generation (caller holds the pool
        lock and has already bumped ``gen``): returns the old (work
        queue, threads) and installs started fresh ones."""
        old_work, old_threads = self.work, [self._launcher, self._completer]
        self._spawn()
        self.start()
        return old_work, old_threads

    def _on_stream(self, device=None):
        """The replica's stream as the current one (CUDA), for work on
        ``device`` (default: the replica's own)."""
        if self.stream is None or self.pool.engine._dev(device) != self.stream.device:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    # -- launch side ---------------------------------------------------

    def _launch_loop(self, work_q, inflight_q, gen) -> None:
        pool = self.pool
        while True:
            item = work_q.get()
            if item is _CLOSE:
                inflight_q.put(_CLOSE)
                return
            bucket, reqs, depth, probe = item
            if bucket is None:
                self._launch_fallback(reqs, inflight_q, work_q)
                continue
            entry = pool._register(self, bucket, reqs, probe)
            try:
                if not probe:
                    # Deterministic serving-side fault hooks
                    # (docs/RESILIENCE.md): slow_replica stalls this
                    # launch, replica_crash raises, replica_hang blocks
                    # until the plan is cleared (the releasable wedge).
                    fault = faults.replica_launch_fault()
                    if fault.delay > 0.0:
                        time.sleep(fault.delay)
                    if fault.hang is not None:
                        fault.hang.wait()  # released by faults.clear/install
                        if entry.state != "live" or gen != self.gen:
                            # This generation was retired mid-hang. If
                            # the watchdog took our batch it was already
                            # re-dispatched (claim fails, nothing to do);
                            # but a quarantine triggered by a DIFFERENT
                            # batch leaves ours live with no one else
                            # responsible — hand it back to the pool
                            # rather than stranding its futures until
                            # (or past, with the watchdog off) expiry.
                            if pool._claim(entry):
                                pool._redispatch(
                                    bucket, reqs,
                                    ReplicaUnavailable(
                                        f"replica {self.index} retired "
                                        "its worker generation mid-hang"
                                    ),
                                    count_retry=False,
                                )
                            inflight_q.put(_CLOSE)
                            return
                    if fault.crash:
                        raise RuntimeError(
                            f"injected replica_crash on replica {self.index}"
                        )
                n_slots = pool.max_batch
                serve = self.executables[(bucket, n_slots)]
                images = [r.image for r in reqs]
                t0 = time.perf_counter()
                with self._on_stream(self.device):
                    out = start_readback(serve(images, params=self.params))
                if not probe:
                    bh, bw = bucket
                    pool.stats.record_batch(
                        n_real=len(reqs),
                        n_slots=n_slots,
                        real_px=sum(
                            im.shape[0] * im.shape[1] for im in images
                        ),
                        padded_px=n_slots * bh * bw,
                        queue_depth=depth,
                        replica=self.index,
                        tier=pool.tier,
                    )
                entry.t0 = t0
                if trace.enabled():
                    # Replica launch: host preprocess + the enqueue.
                    # The span closes here — the device itself is still
                    # computing; its span closes at the completion
                    # thread's existing wait, never via a new sync.
                    t_disp = time.perf_counter()
                    for r in reqs:
                        trace.record_span(
                            "replica_launch", "serving", t0, t_disp,
                            args={
                                "request_id": getattr(r, "req_id", None),
                                "replica": self.index,
                                "tier": pool.tier,
                                "bucket": f"{bucket[0]}x{bucket[1]}",
                                "batch": len(reqs),
                            },
                        )
                inflight_q.put((out, entry))
            except BaseException as err:
                pool._on_batch_failure(entry, err, kind="crash")

    def _launch_fallback(self, reqs, inflight_q, work_q) -> None:
        """Oversize for every bucket: native-shape forwards, one request
        each (mixed oversize shapes cannot stack). These go through
        ``engine.enhance_async`` on the engine's device, so a shape they
        meet first is a real cold start — count it (stats.compiles is
        "shapes warmed", warmup AND fallback). Routed to the lowest-index
        available replica; because quarantine can move that routing
        mid-stream (two launch threads could interleave their
        before/after shape-count probes on the shared engine), the
        probe+dispatch bracket is serialized under the pool's fallback
        lock — dispatch is async, so the lock never covers device compute
        or the readback."""
        pool = self.pool
        # ONE request per work item: the rest of a group goes back on our
        # queue as a fresh item, where it stays visible to the supervisor
        # — not-yet-started requests held in this thread's locals would
        # be invisible to generation retirement if this launch wedges,
        # stranding their futures and leaking outstanding counts.
        r, rest = reqs[0], list(reqs[1:])
        if rest:
            work_q.put((None, rest, 0, False))
        # Take the accounting lock BEFORE registering the watchdog entry:
        # time spent waiting behind another replica's fallback must not
        # count against this batch's deadline — otherwise one wedged
        # fallback would cascade false hang-quarantines through every
        # replica queued on the lock. The bound is sized to a FALLBACK's
        # cold start (the same reason fallback_watchdog_sec defaults to
        # exempt), so only a genuine wedge ever trips it: past it we
        # launch WITHOUT the shape-count bracket (availability over
        # accounting).
        fb_wd = pool.supervision.fallback_watchdog_sec
        locked = pool._fallback_lock.acquire(
            timeout=fb_wd if fb_wd is not None else 600.0
        )
        entry = pool._register(self, None, [r], False)
        try:
            try:
                pool.stats.record_fallback()
                before = (
                    engine_jit_cache_size(pool.engine) if locked else None
                )
                t0 = time.perf_counter()
                with self._on_stream():
                    out = start_readback(pool.engine.enhance_async(r.image[None]))
                if locked:
                    grew = engine_jit_cache_size(pool.engine) - before
                    if grew > 0:
                        pool.stats.record_compile(grew)
            finally:
                # Released before the bounded inflight put: D2H
                # backpressure must never be felt through the lock.
                if locked:
                    pool._fallback_lock.release()
                    locked = False
            entry.t0 = t0
            inflight_q.put((out, entry))
        except BaseException as err:
            pool._on_batch_failure(entry, err, kind="crash")

    # -- completion side -----------------------------------------------

    def _complete_loop(self, inflight_q) -> None:
        pool = self.pool
        while True:
            item = inflight_q.get()
            if item is _CLOSE:
                return
            readback, entry = item
            t_d2h0 = time.perf_counter() if trace.enabled() else None
            try:
                # This replica's one wait: on its readback's event.
                raw = finish_readback(readback).numpy()
            except BaseException as err:
                pool._on_batch_failure(entry, err, kind="crash")
                continue
            if not entry.probe:
                # nan_output@K: poison the host copy on cue so the guard
                # below is deterministically testable.
                raw = faults.poison_replica_output(raw)
            if pool.supervision.output_guard and not _output_ok(
                raw, entry.reqs
            ):
                pool._on_batch_failure(
                    entry,
                    BadOutput(
                        f"replica {self.index} produced a non-finite or "
                        "all-zero output canvas"
                    ),
                    kind="bad_output",
                )
                continue
            if not pool._claim(entry):
                # The watchdog aborted this batch while we were syncing
                # and its requests were re-dispatched elsewhere — discard
                # the late result (single delivery; byte-identical either
                # way).
                continue
            arr = ten2arr(torch.from_numpy(raw))
            t_done = time.perf_counter()
            if entry.probe:
                entry.reqs[0].future.set_result(True)
                continue
            for i, r in enumerate(entry.reqs):
                if r.future.done():
                    continue
                h, w = r.image.shape[:2]
                r.future.set_result(arr[i, :h, :w])
                pool.stats.record_latency(
                    t_done - r.t_submit, replica=self.index, tier=pool.tier
                )
                if t_d2h0 is not None:
                    # Device span closed at the existing D2H above (no
                    # added sync); the serve span is the request's whole
                    # submit -> result wall, the trace's per-request root.
                    rid = getattr(r, "req_id", None)
                    common = {"request_id": rid, "replica": self.index,
                              "tier": pool.tier}
                    if entry.t0 is not None:
                        trace.record_span(
                            "device", "serving", entry.t0, t_done,
                            args=common,
                        )
                    trace.record_span(
                        "d2h", "serving", t_d2h0, t_done, args=common,
                    )
                    trace.record_span(
                        "serve", "serving", r.t_submit, t_done,
                        args=dict(common, retries=getattr(r, "retries", 0)),
                    )
            if entry.t0 is not None:
                pool.stats.record_replica_busy(self.index, t_done - entry.t0)

def _output_ok(raw: np.ndarray, reqs) -> bool:
    """The output sanity guard: False for non-finite values (a NaN that
    crept through the forward) or an all-zero canvas (a transfer that
    delivered an unwritten buffer) — the two cheap whole-batch
    signatures of device corruption. One float64 sum is the whole fast
    path: NaN/Inf propagate through it (no canvas-sized bool temporary
    like ``np.isfinite(raw).all()`` would allocate), outputs are bounded
    so the f64 accumulation cannot overflow, and a nonzero sum proves a
    nonzero canvas. The element scans only run on the rare zero-sum
    path. The all-zero arm only fires when some INPUT pixel was nonzero:
    a legitimately all-black frame maps to an all-black enhancement, and
    quarantining a healthy replica over it (then failing the request
    after byte-identical retries) would turn one dark upload into an
    availability incident."""
    total = np.sum(raw, dtype=np.float64)
    if not np.isfinite(total):
        return False
    if total != 0.0:
        return True
    if raw.any():  # exact cancellation of signed values: nonzero canvas
        return True
    return not any(r.image.any() for r in reqs)


class ReplicaPool:
    """Place the warmed serving grid on ``n_replicas`` devices and
    multiplex dispatched micro-batches over them, under supervision.

    Warmup runs the full ``len(ladder) x len(batch_sizes) x n_replicas``
    grid once before construction returns (serving/warmup.py), so no
    request meets a cold shape on any replica (the engine's
    ``cold_dispatches`` stays 0), and re-warm probes reuse the grid, so
    quarantine cycles meet no new shape either.
    """

    def __init__(
        self,
        engine,
        ladder: BucketLadder,
        batch_sizes: Sequence[int],
        n_replicas: int = 1,
        max_inflight_per_replica: int = 2,
        stats: Optional[ServingStats] = None,
        warmup_verbose: bool = False,
        tier: str = "quality",
        supervision: Optional[SupervisionConfig] = None,
    ):
        if max_inflight_per_replica < 1:
            raise ValueError(
                f"max_inflight_per_replica must be >= 1, got "
                f"{max_inflight_per_replica}"
            )
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        if engine.sharded and n_replicas != 1:
            raise ValueError(
                "sharded engines serve as ONE replica spanning their mesh; "
                f"got n_replicas={n_replicas} with data_shards={engine.data_shards}, "
                f"spatial_shards={engine.spatial_shards}"
            )
        if _cuda_engine(engine):
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            if n_replicas > len(devices):
                raise ValueError(
                    f"n_replicas={n_replicas} exceeds the {len(devices)} CUDA "
                    "device(s)"
                )
        else:
            devices = [engine.device] * n_replicas
        self.engine = engine
        self.max_batch = max(int(b) for b in batch_sizes)
        self.max_inflight = int(max_inflight_per_replica)
        self.stats = stats if stats is not None else ServingStats()
        self.stats.set_replicas(n_replicas)
        self.supervision = supervision if supervision is not None else SupervisionConfig()
        # Which serving tier this pool's batches/requests count under
        # (docs/SERVING.md "Quality tiers"): "quality" for the WaterNet
        # pipeline, "fast" for the CAN student's pool of a tier-routing
        # batcher.
        self.tier = str(tier)
        self.stats.declare_tier(self.tier)
        self._lock = threading.Lock()
        # Serializes the oversize-fallback shape-count probe bracket: the
        # lowest-AVAILABLE-index routing can move across replicas during
        # a quarantine window, and two interleaved before/after probes
        # would mis-count compiles.
        self._fallback_lock = threading.Lock()
        self._closed = False  # guarded-by: self._lock
        # live _Inflight entries (watchdog scope)
        self._watch: set = set()  # guarded-by: self._lock
        self._old_threads: List[threading.Thread] = []  # guarded-by: self._lock
        self.leaked_threads: List[str] = []  # guarded-by: self._lock
        self._probe_bucket = min(ladder, key=lambda b: b[0] * b[1])
        # A single replica keeps the engine's own placement and weights
        # (device None).
        dev_list = [None] if n_replicas == 1 else list(devices[:n_replicas])
        self._replicas: List[_Replica] = [
            _Replica(self, i, dev) for i, dev in enumerate(dev_list)
        ]
        grids = warmup(
            engine, ladder, batch_sizes, stats=self.stats,
            verbose=warmup_verbose,
            replicas=[(r.index, r.device, r.params, r.stream) for r in self._replicas],
        )
        for r in self._replicas:
            r.executables = grids[r.index]
        for r in self._replicas:
            r.start()
        self._stop_supervisor = threading.Event()
        self._supervisor = threading.Thread(
            target=self._supervise,
            name=f"{THREAD_PREFIX}-serve-supervisor-{self.tier}",
            daemon=True,
        )
        self._supervisor.start()

    @property
    def n_replicas(self) -> int:
        return len(self._replicas)

    def health(self) -> Dict[int, str]:
        """Live per-replica health states, by index."""
        with self._lock:
            return {r.index: r.state for r in self._replicas}

    def has_idle_replica(self) -> bool:
        """True when some available replica has nothing dispatched and
        nothing in flight — i.e. a batch flushed right now would start
        computing immediately instead of queueing behind earlier
        batches. The adaptive dispatcher's work-conserving hold reads
        this (serving/batcher.py): while it is False, flushing a partial
        bucket early cannot improve latency, it only locks in a
        slot-padded partial batch."""
        with self._lock:
            return any(
                r.state in AVAILABLE_STATES and r.outstanding == 0
                for r in self._replicas
            )

    # -- dispatch ------------------------------------------------------

    def _pick_replica(self, bucket, exclude=None) -> _Replica:
        """Least-loaded available replica (lowest index on ties; lowest
        available index for fallback groups), preferring any replica
        other than ``exclude``. Caller holds the pool lock. Raises
        :class:`ReplicaUnavailable` when everything is quarantined."""
        avail = [r for r in self._replicas if r.state in AVAILABLE_STATES]
        if not avail:
            raise ReplicaUnavailable(
                f"all {len(self._replicas)} replica(s) of the "
                f"{self.tier!r} pool are quarantined"
            )
        others = [r for r in avail if r is not exclude]
        pool = others or avail
        if bucket is None:
            return min(pool, key=lambda r: r.index)
        return min(pool, key=lambda r: (r.outstanding, r.index))

    def dispatch(self, bucket: Optional[Bucket], reqs, queue_depth: int = 0) -> None:
        """Route one coalesced micro-batch (or a fallback group for
        ``bucket is None``) to the least-loaded available replica. Never
        blocks: work queues are unbounded — the per-replica in-flight
        bound throttles device memory, not the dispatcher. Raises
        :class:`ReplicaUnavailable` when every replica is quarantined
        (the batcher turns that into per-request errors; the front door
        has been answering 503 on /healthz since the last quarantine)."""
        if not reqs:
            return
        with self._lock:
            replica = self._pick_replica(bucket)
            # Fallback groups launch one forward per request.
            replica.outstanding += len(reqs) if bucket is None else 1
            replica.work.put((bucket, reqs, queue_depth, False))

    # -- supervision core ----------------------------------------------

    def _register(self, replica, bucket, reqs, probe) -> _Inflight:
        """A launch thread started work on a batch: put it under watchdog
        supervision. Oversize fallbacks (``bucket is None``) use the
        separate ``fallback_watchdog_sec`` (default None = exempt): their
        launch meets a native shape cold, which a bucketed-batch-sized
        watchdog could misread as a hang — see :class:`SupervisionConfig`
        for the tradeoff."""
        wd = (
            self.supervision.fallback_watchdog_sec
            if bucket is None
            else self.supervision.watchdog_sec
        )
        deadline = None if wd is None else time.perf_counter() + wd
        entry = _Inflight(replica, bucket, reqs, deadline, probe)
        with self._lock:
            self._watch.add(entry)
        return entry

    def _claim(self, entry: _Inflight) -> bool:
        """Atomically take ownership of a live batch (exactly one of:
        the completer delivering it, a failure handler retrying it, or
        the watchdog aborting it wins). False means someone else already
        owns it — the caller must discard its copy."""
        with self._lock:
            if entry.state != "live":
                return False
            entry.state = "claimed"
            self._watch.discard(entry)
            if not entry.probe:
                entry.replica.outstanding -= 1
            return True

    def _on_batch_failure(self, entry: _Inflight, err, kind: str) -> None:
        """A batch demonstrably failed (launch raised, D2H raised, or
        the output guard rejected the result): record the strike on its
        replica and transparently re-dispatch its requests."""
        if not self._claim(entry):
            return  # the watchdog already took it (hang abort)
        replica = entry.replica
        if entry.probe:
            if not entry.reqs[0].future.done():
                entry.reqs[0].future.set_exception(err)
            return
        if kind == "bad_output":
            self.stats.record_nan_output()
        if entry.bucket is None:
            # Oversize fallbacks run on the ENGINE'S DEFAULT device
            # regardless of which replica's launch thread carried them:
            # their failure says nothing about that replica's health, so
            # no strike and no exclusion — the bounded retry (same
            # device, transient faults only) is all re-dispatch can buy.
            self._redispatch(entry.bucket, entry.reqs, err)
            return
        with self._lock:
            if kind == "bad_output":
                replica.bad_outputs += 1
            else:
                replica.crashes += 1
            if replica.state == HEALTHY:
                # One strike -> suspect; the supervisor quarantines and
                # re-warms on its next scan. (A quarantined/rewarming
                # replica can still report failures from batches launched
                # before the transition — those stay where they are.)
                replica.state = SUSPECT
        self._redispatch(entry.bucket, entry.reqs, err, exclude=replica)

    def _redispatch(
        self, bucket, reqs, err, count_retry: bool = True, exclude=None
    ) -> None:
        """Re-queue requests from a failed (or never-started, when
        ``count_retry=False``) batch onto a surviving replica —
        ``exclude`` (the replica that just failed, usually still only
        SUSPECT and therefore available) is avoided whenever any other
        replica can take the work, so a persistently sick device cannot
        burn the whole retry budget before the supervisor's next scan
        quarantines it. Bounded by the per-request retry budget. Results
        are byte-identical to a first-try serve (replica invariance),
        and only demonstrably failed work ever gets here — successes are
        never recomputed (the claim protocol). Requests whose deadline
        passed while their batch was failing are dropped here with the
        same un-computed-504 policy the dispatcher applies at flush — a
        response nobody waits for is wasted device time, and the retry
        path must not be the one door that serves dead work late."""
        now = time.perf_counter()
        live: List = []
        for r in reqs:
            if r.future.done():
                continue
            if getattr(r.future, "abandoned", False):
                # The caller walked away (stream disconnect /
                # drop-oldest) while the batch was failing; the claim
                # protocol hands this path sole ownership, so resolving
                # here cannot race the completion thread.
                from waternet_tpu_torch.serving.batcher import RequestCancelled

                r.future.set_exception(
                    RequestCancelled(
                        "request abandoned by its caller; dropped "
                        "instead of retried"
                    )
                )
                continue
            deadline = getattr(r, "deadline", None)
            if deadline is not None and deadline <= now:
                from waternet_tpu_torch.serving.batcher import DeadlineExpired

                self.stats.record_deadline_expired()
                r.future.set_exception(
                    DeadlineExpired(
                        "deadline expired while the batch was being "
                        "retried; dropped un-computed"
                    )
                )
                continue
            live.append(r)
        if not live:
            return
        retryable: List = []
        for r in live:
            if count_retry:
                r.retries = getattr(r, "retries", 0) + 1
            if getattr(r, "retries", 0) <= self.supervision.max_retries:
                retryable.append(r)
            else:
                if not r.future.done():
                    r.future.set_exception(err)
        if not retryable:
            return
        try:
            with self._lock:
                replica = self._pick_replica(bucket, exclude=exclude)
                replica.outstanding += (
                    len(retryable) if bucket is None else 1
                )
                replica.work.put((bucket, retryable, 0, False))
            if count_retry:
                self.stats.record_retry(len(retryable))
            if trace.enabled():
                # Re-dispatch hop markers, outside the pool lock: a
                # re-dispatched request's span chain shows the hop
                # between its failed and its serving replica.
                t_hop = time.perf_counter()
                for r in retryable:
                    trace.record_instant(
                        "redispatch", "serving", t=t_hop,
                        args={
                            "request_id": getattr(r, "req_id", None),
                            "retry": getattr(r, "retries", 0),
                            "to_replica": replica.index,
                            "tier": self.tier,
                            "error": type(err).__name__
                            if err is not None else None,
                        },
                    )
        except ReplicaUnavailable as unavailable:
            final = unavailable if err is None else err
            for r in retryable:
                if not r.future.done():
                    r.future.set_exception(final)

    def _retire_generation(self, replica: _Replica):  # guarded-by: self._lock
        """Replace a replica's current worker generation (caller holds
        the pool lock): bump ``gen`` so a later-waking wedged thread
        knows to exit, spawn fresh threads on fresh queues, keep the old
        threads joinable for :meth:`close`, and drain the old work queue
        — adjusting ``outstanding`` for dispatched (non-probe) items.
        Returns ``(old_work_queue, drained_items)``; the caller must put
        ``_CLOSE`` on the old queue AFTER releasing the lock and dispose
        of the drained items (re-dispatch vs fail, depending on why the
        generation died)."""
        replica.gen += 1
        old_work, old_threads = replica.respawn()
        self._old_threads.extend(old_threads)
        drained: List = []
        try:
            while True:
                item = old_work.get_nowait()
                if item is _CLOSE:
                    continue
                drained.append(item)
                if not item[3]:  # probes never count toward outstanding
                    replica.outstanding -= (
                        len(item[1]) if item[0] is None else 1
                    )
        except queue.Empty:
            pass
        return old_work, drained

    def _quarantine(self, replica: _Replica, reason: str) -> None:
        """Take a replica out of rotation: bump its worker generation
        (retiring possibly-wedged threads), drain its never-started work
        back to the pool, and schedule a re-warm probe. In-flight batches
        keep their watchdog entries — a live one either completes through
        the old completer (claims still win) or expires and re-dispatches."""
        with self._lock:
            # No generation churn once close() latched _closed (both
            # hold this lock): a respawn here would create fresh threads
            # close() never sees — an unjoined, unreported leak.
            if self._closed or replica.state in (QUARANTINED, REWARMING):
                return
            replica.state = QUARANTINED
            replica.quarantines += 1
            now = time.perf_counter()
            replica._quarantined_at = now
            replica._rewarm_backoff = self.supervision.rewarm_backoff_sec
            replica._next_rewarm_at = now + replica._rewarm_backoff
            replica._probe = None
            old_work, stranded = self._retire_generation(replica)
        old_work.put(_CLOSE)  # retire an idle (non-wedged) old launcher
        self.stats.record_quarantine()
        for bucket, reqs, _depth, _probe in stranded:
            # Never-started work: re-route without burning retry budget
            # (nothing was computed, nothing demonstrably failed).
            self._redispatch(
                bucket, reqs,
                ReplicaUnavailable(
                    f"replica {replica.index} quarantined ({reason}) with "
                    "queued work and no surviving replica"
                ),
                count_retry=False,
            )

    def _supervise(self) -> None:
        while not self._stop_supervisor.wait(
            self.supervision.scan_interval_sec
        ):
            try:
                self._supervise_once()
            except Exception as err:  # pragma: no cover - defensive
                print(
                    f"ReplicaPool supervisor error ({self.tier}): "
                    f"{type(err).__name__}: {err}",
                    file=sys.stderr,
                    flush=True,
                )

    def _supervise_once(self) -> None:
        now = time.perf_counter()
        expired: List[_Inflight] = []
        with self._lock:
            if self._closed:
                return
            for e in list(self._watch):
                if (
                    e.state == "live"
                    and e.deadline is not None
                    and e.deadline <= now
                ):
                    e.state = "aborted"
                    self._watch.discard(e)
                    if not e.probe:
                        e.replica.outstanding -= 1
                    expired.append(e)
        for e in expired:
            r = e.replica
            if e.probe:
                # The re-warm probe itself hung: the device is still
                # sick. The fresh launcher is now wedged on it, so a
                # respawn is mandatory — without one, the next probe
                # would queue behind the wedged thread forever and the
                # replica would strand in REWARMING.
                self._probe_failed(r, now, respawn=True)
                if not e.reqs[0].future.done():
                    e.reqs[0].future.set_exception(
                        ReplicaUnavailable("re-warm probe timed out")
                    )
                continue
            if e.bucket is None:
                # A hung OVERSIZE FALLBACK (fallback_watchdog_sec armed):
                # the wedge is the carrier THREAD and the engine's
                # default device — like fallback crashes, it says
                # nothing about this replica's health. Replace the
                # worker generation (freeing the queued work behind the
                # wedged launcher) WITHOUT a quarantine strike, and
                # requeue everything.
                with self._lock:
                    if self._closed:
                        continue
                    old_work, drained = self._retire_generation(r)
                old_work.put(_CLOSE)
                for item in drained:
                    self._redispatch(
                        item[0], item[1],
                        ReplicaUnavailable(
                            "work retired behind a hung oversize fallback"
                        ),
                        count_retry=False,
                    )
                self._redispatch(
                    e.bucket, e.reqs,
                    ReplicaUnavailable(
                        "oversize fallback hung past "
                        f"fallback_watchdog_sec="
                        f"{self.supervision.fallback_watchdog_sec}"
                    ),
                )
                continue
            with self._lock:
                r.hangs += 1
            self._quarantine(r, reason="hang")
            self._redispatch(
                e.bucket, e.reqs,
                ReplicaUnavailable(
                    f"replica {r.index} hung past the "
                    f"{self.supervision.watchdog_sec}s watchdog"
                ),
                exclude=r,
            )
        # The replica flag checks below run on a SNAPSHOT taken under
        # the pool lock: worker threads flip ``state`` under the lock
        # (crash -> SUSPECT in _on_batch_failure), and an unlocked scan
        # could pair a fresh state with a stale ``_next_rewarm_at`` /
        # ``_probe`` left over from the previous quarantine cycle. Every
        # transition helper re-checks state under the lock before
        # acting, so the snapshot is safe as well as consistent.
        with self._lock:
            scan = [
                (r, r.state, r._next_rewarm_at, r._probe)
                for r in self._replicas
            ]
        # Promote suspects to quarantine (their failed batch already
        # re-dispatched in _on_batch_failure).
        for r, state, _, _ in scan:
            if state == SUSPECT:
                self._quarantine(r, reason="crash")
        # Re-warm due quarantined replicas; reintegrate finished probes.
        for r, state, next_rewarm_at, probe in scan:
            if state == QUARANTINED and now >= next_rewarm_at:
                self._start_probe(r)
            elif state == REWARMING and probe is not None and probe.done():
                if probe.exception() is None:
                    self._reintegrate(r)
                else:
                    # The probe raised (launcher alive): back off and
                    # retry later — no respawn needed.
                    self._probe_failed(r, now, respawn=False)

    def _probe_failed(self, replica: _Replica, now: float, respawn: bool) -> None:
        """A re-warm probe hung (``respawn=True`` — its launcher is
        wedged and must be replaced) or raised (``respawn=False``): stay
        quarantined with a doubled backoff, ready for the next probe."""
        stale_probes: List = []
        with self._lock:
            if self._closed:
                return  # close() owns thread lifecycle from here on
            if replica.state == REWARMING:
                replica.state = QUARANTINED
            replica._rewarm_backoff = min(
                max(replica._rewarm_backoff, self.supervision.rewarm_backoff_sec) * 2,
                self.supervision.max_rewarm_backoff_sec,
            )
            replica._next_rewarm_at = now + replica._rewarm_backoff
            replica._probe = None
            if respawn:
                old_work, drained = self._retire_generation(replica)
                # A quarantined replica's queue only ever holds probes;
                # fail any stale ones rather than re-routing them.
                for item in drained:
                    stale_probes.extend(item[1])
        if respawn:
            old_work.put(_CLOSE)
        for p in stale_probes:
            if not p.future.done():
                p.future.set_exception(
                    ReplicaUnavailable("stale re-warm probe retired")
                )

    def _start_probe(self, replica: _Replica) -> None:
        """Push one watchdog-guarded probe batch through the replica's
        fresh threads and EXISTING warmed callables (a shape already
        warm: no cold dispatch across quarantine cycles)."""
        req = _ProbeRequest(probe_image(self._probe_bucket))
        with self._lock:
            if self._closed or replica.state != QUARANTINED:
                return
            replica.state = REWARMING
            replica._probe = req.future
            replica.work.put((self._probe_bucket, [req], 0, True))

    def _reintegrate(self, replica: _Replica) -> None:
        with self._lock:
            if replica.state != REWARMING:
                return
            replica.state = HEALTHY
            replica.reintegrations += 1
            replica._probe = None
            recovery = (
                time.perf_counter() - replica._quarantined_at
                if replica._quarantined_at is not None
                else 0.0
            )
            replica._quarantined_at = None
        self.stats.record_reintegration(recovery)

    # -- params / lifecycle --------------------------------------------

    def set_params(self, params) -> None:
        """Hot weight reload: place the state_dict ``params`` on every
        replica's device and swap each replica's model between batches.

        Attribute assignment is atomic under the GIL and a launch thread
        reads ``replica.params`` exactly once per batch, so every batch
        runs entirely on old or entirely on new weights — in-flight
        batches complete on the model they were launched with, and no
        request is dropped. The engine's own model swaps too
        (:meth:`InferenceEngine.set_params`), so oversize fallbacks serve
        the new weights as well. Callers validate names / shapes / dtypes
        first; see serving/server.py's reload endpoint.
        """
        self.engine.set_params(params)
        for r in self._replicas:
            r.params = self.engine.replica_params(r.device)

    def close(self, timeout: float = 60.0) -> List[str]:
        """Drain every replica's queued work, stop the supervisor and all
        worker threads, and join them. A thread that fails to join within
        ``timeout`` (wedged in device work — the watchdog's quarry) is
        reported **loudly** on stderr and returned by name, never
        silently leaked: the caller (and the test suite's thread-leak
        guard) can see exactly which worker is stuck. Idempotent; safe
        from ``finally``."""
        with self._lock:
            if self._closed:
                return list(self.leaked_threads)
            self._closed = True
        self._stop_supervisor.set()
        threads: List[threading.Thread] = [self._supervisor]
        for r in self._replicas:
            r.work.put(_CLOSE)
            threads.extend([r._launcher, r._completer])
        threads.extend(self._old_threads)
        deadline = time.monotonic() + timeout
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        leaked = [t.name for t in threads if t.is_alive()]
        # Published under the lock: a concurrent close() (batcher close
        # racing a test's finally) returns this list through the locked
        # early-exit above, and an unlocked publish could hand it a torn
        # view — the race threadlint R101 surfaced when leaked_threads
        # gained its guarded-by declaration.
        with self._lock:
            self.leaked_threads = leaked
        if leaked:
            print(
                f"ReplicaPool.close ({self.tier}): {len(leaked)} worker "
                f"thread(s) failed to join within {timeout:.1f}s — wedged "
                f"in device work and cannot be interrupted, only "
                f"abandoned: {leaked}",
                file=sys.stderr,
                flush=True,
            )
        return leaked
