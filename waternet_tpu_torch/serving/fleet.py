"""Fleet front tier: a supervising router over N serving workers.

The JAX package's ``serving/fleet.py``, lifted: the router is stdlib
code, and its workers are ``python -m waternet_tpu_torch.serving.server``
processes, on the card unless their arguments say ``--device cpu``
(``python -m waternet_tpu_torch.serving.fleet --workers 2 -- --weights
w.npz``). One serving process cannot carry a fleet's traffic, and a
crashed or wedged gateway must not be a client-visible event:

* **Supervision** — the router spawns N serving workers on ephemeral
  ports and drives :class:`waternet_tpu_torch.resilience.heartbeat.WorkerHealth`
  (``live_phase="serve"``) per worker off file heartbeats plus
  ``/healthz`` polls, as the JAX package's resilience/supervisor.py does for train
  gangs. Crashed or hung workers are drained (SIGTERM), SIGKILLed past
  the grace window, and relaunched as fresh generations on new ports.
* **Routing** — ``/enhance`` goes to the least-loaded ready worker,
  skipping workers whose queue gauge projects past the request's
  ``X-Deadline-Ms`` budget; ``/stream`` sessions pin to a worker by
  consistent hashing on the session id (:class:`HashRing`), so a
  membership change remaps ONLY the dead worker's arc and every other
  pinned session stays put.
* **Failover** — a request in flight on a worker that dies mid-answer is
  transparently re-dispatched to another ready worker (bounded by
  ``route_retries``), with ``X-Request-Id`` preserved across the hop;
  responses are byte-identical by replica invariance (the workers run
  the same weights through the same compiled buckets). Worker verdicts
  (429/503/504) relay verbatim — ``Retry-After`` and ``X-Request-Id``
  pass through untouched, they are answers, not failures.
* **SLO closed loop** — the router feeds its own sliding windows of
  relayed outcomes to a :class:`waternet_tpu_torch.obs.slo.SloEngine`;
  sustained ``page`` burn triggers a worker scale-up (to
  ``--max-workers``) plus a fleet-wide brown-out (every worker's
  downgrade watermark lowered via ``POST /admin/policy``), and sustained
  ``ok`` scales back down and restores the baseline policy. Every
  transition is logged with its triggering objective and surfaced on the
  router's ``/stats``, ``/healthz`` (per-worker health map), and
  ``/metrics``.
* **Forecast-driven autoscaling** — when the armed SLO has a latency
  objective, a :class:`waternet_tpu_torch.serving.adaptive.QueueForecaster`
  tracks aggregate worker queue depth each control tick and scales the
  fleet up on a *predicted* objective breach — BEFORE the burn-rate
  engine pages, so capacity lands ahead of the brown-out rung — and
  down on a sustained low forecast. Forecast actions share the burn
  loop's scale cooldown (one scaler, two triggers) and never touch the
  brown-out policy; they log as ``forecast_scale_up`` /
  ``forecast_scale_down``.
* **Copy-lean relay** — ``/enhance`` worker answers stream through the
  router in 64 KiB chunks once the response head has parsed, instead of
  being rebuffered whole; the full body is tee-accumulated only when
  the router response cache will store it. A worker that dies before
  the head commits still re-dispatches exactly as before.

The router itself is hand-rolled asyncio HTTP with no model, so it
stays cheap to run next to the workers and testable with stub workers
(``tests/fleet_worker.py``). Fault kinds ``gateway_crash@K`` /
``gateway_hang@K`` (``resilience/faults.py``) drill the failover
deterministically, and ``python -m waternet_tpu_torch.bench --config
serve_fleet`` pins the chaos contract.
"""

from __future__ import annotations

import argparse
import asyncio
import bisect
import hashlib
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from waternet_tpu_torch.data.pipeline import THREAD_PREFIX
from waternet_tpu_torch.obs import trace
from waternet_tpu_torch.obs import window as obswin
from waternet_tpu_torch.obs.slo import SloEngine, WindowSample, parse_slo
from waternet_tpu_torch.serving.adaptive import (
    QueueForecaster,
    empty_forecast_block,
)
from waternet_tpu_torch.resilience.heartbeat import (
    ENV_HEARTBEAT_DIR,
    ENV_HEARTBEAT_SEC,
    ENV_WORKER_GENERATION,
    ENV_WORKER_ID,
    ENV_WORKER_SLOT,
    WorkerHealth,
    heartbeat_path,
    read_heartbeat,
)
from waternet_tpu_torch.serving.reuse import ResponseCache, empty_cache_block

__all__ = [
    "FleetPolicy",
    "FleetRouter",
    "HashRing",
    "worker_id",
    "main",
]

MAX_BODY_BYTES = 64 << 20

_REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 413: "Payload Too Large",
    429: "Too Many Requests", 500: "Internal Server Error",
    503: "Service Unavailable", 504: "Gateway Timeout",
}

#: Response headers relayed verbatim from worker answers — the backoff
#: hint (Retry-After), the correlation id, and the serving facts a
#: client ledger splits on must all survive the extra hop.
_RELAY_HEADERS = (
    "content-type", "retry-after", "x-request-id", "x-tier-served",
    "x-worker-id", "x-cache",
)

#: Request headers forwarded to the chosen worker (everything the
#: serving contract reads; hop-by-hop headers are rebuilt, not copied).
_FORWARD_HEADERS = (
    "content-type", "x-request-id", "x-tier", "x-tier-allow-downgrade",
    "x-deadline-ms", "x-stream-window", "x-stream-fps",
    "x-stream-reuse", "x-stream-max-reuse-run", "x-stream-reuse-warp",
)


def worker_id(slot: int, generation: int) -> str:
    """The opaque id a worker stamps as ``X-Worker-Id``: slot identity
    plus restart generation, so a relaunched worker is distinguishable
    in client ledgers from the generation it replaced."""
    return f"w{int(slot)}g{int(generation)}"


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _request_id(headers: dict) -> str:
    """Same contract as the worker front door: accept a sane client
    ``X-Request-Id`` token, replace anything that could smuggle CRLF."""
    raw = headers.get("x-request-id", "").strip()
    if (
        raw
        and len(raw) <= 128
        and all(c.isalnum() or c in "-_.:/" for c in raw)
    ):
        return raw
    return trace.new_request_id()


def _content_length(headers: dict) -> int:
    try:
        return max(0, int(headers.get("content-length", "0")))
    except ValueError:
        return 0


def backoff_sec(base: float, cap: float, restart_index: int) -> float:
    """Exponential relaunch backoff, same shape as the train supervisor's
    (a serving slot that dies at boot must not busy-loop Popen)."""
    if base <= 0:
        return 0.0
    return min(cap, base * (2.0 ** max(0, restart_index - 1)))


# ----------------------------------------------------------------------
# Consistent hashing
# ----------------------------------------------------------------------


class HashRing:
    """Deterministic consistent-hash ring over worker slots.

    Each member slot owns ``vnodes`` points on a 2^64 ring, placed by
    sha256 of ``"slot:vnode"`` — fully deterministic, no process seed,
    so the session→slot mapping is reproducible across router restarts
    and pinned in tests. Removing a slot deletes only its points:
    sessions hashing into the removed arcs fall to the next point
    clockwise, and every other session's mapping is untouched (the
    single-arc-remap property tests/test_fleet.py asserts).

    Not self-locked: the router owns membership under its own lock.
    """

    def __init__(self, vnodes: int = 64):
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self.vnodes = int(vnodes)
        self._points: List[int] = []  # sorted ring positions
        self._owner: Dict[int, int] = {}  # point -> slot
        self._members: Dict[int, List[int]] = {}  # slot -> its points

    @staticmethod
    def _hash(key: str) -> int:
        return int.from_bytes(
            hashlib.sha256(key.encode("utf-8")).digest()[:8], "big"
        )

    def add(self, slot: int) -> None:
        if slot in self._members:
            return
        points = []
        for v in range(self.vnodes):
            p = self._hash(f"{int(slot)}:{v}")
            # sha256 collisions across distinct keys are not a practical
            # concern; first owner keeps a contested point so add/remove
            # stays an exact inverse.
            if p in self._owner:
                continue
            self._owner[p] = slot
            bisect.insort(self._points, p)
            points.append(p)
        self._members[slot] = points

    def remove(self, slot: int) -> None:
        for p in self._members.pop(slot, ()):
            del self._owner[p]
            i = bisect.bisect_left(self._points, p)
            del self._points[i]

    def members(self) -> List[int]:
        return sorted(self._members)

    def lookup(self, key: str) -> Optional[int]:
        """The slot owning ``key``, or None on an empty ring."""
        if not self._points:
            return None
        h = self._hash(key)
        i = bisect.bisect_right(self._points, h)
        if i == len(self._points):
            i = 0  # wrap: past the last point means the first owner
        return self._owner[self._points[i]]


# ----------------------------------------------------------------------
# Scale / brown-out policy
# ----------------------------------------------------------------------


class FleetPolicy:
    """Pure scale + brown-out decision engine over the SLO alert state.

    The *sustained* part lives in the SLO engine (multi-window burn
    rates escalate, ``hold_sec`` gates de-escalation), so this class
    only maps alert state to fleet actions, with a scale cooldown as the
    anti-flap term. Pure — ``step(now, ...)`` takes explicit time — so
    every decision is unit-testable without processes or sleeps.
    """

    def __init__(
        self,
        min_workers: int,
        max_workers: int,
        cooldown_sec: float = 30.0,
    ):
        if not 1 <= min_workers <= max_workers:
            raise ValueError(
                f"need 1 <= min_workers ({min_workers}) <= max_workers "
                f"({max_workers})"
            )
        self.min_workers = int(min_workers)
        self.max_workers = int(max_workers)
        self.cooldown_sec = float(cooldown_sec)
        self.brownout = False
        self._last_scale: Optional[float] = None

    def _cooled(self, now: float) -> bool:
        return (
            self._last_scale is None
            or now - self._last_scale >= self.cooldown_sec
        )

    # The forecast path scales through the SAME cooldown ledger: a burn
    # scale and a forecast scale are one fleet-level actuator, so one
    # anti-flap term must gate both.
    def cooled(self, now: float) -> bool:
        """True when the scale cooldown allows another action at ``now``."""
        return self._cooled(now)

    def note_scale(self, now: float) -> None:
        """Record an external (forecast-driven) scale action so the
        cooldown applies to the next decision from either trigger."""
        self._last_scale = now

    def step(self, now: float, slo_state: str, n_workers: int) -> List[str]:
        """Actions for one control tick: any of ``brownout`` /
        ``restore`` / ``scale_up`` / ``scale_down``, in apply order.
        Brown-out tracks the paging edge exactly; scaling additionally
        respects the cooldown and the worker bounds."""
        actions: List[str] = []
        if slo_state == "page":
            if not self.brownout:
                self.brownout = True
                actions.append("brownout")
            if n_workers < self.max_workers and self._cooled(now):
                self._last_scale = now
                actions.append("scale_up")
        elif slo_state == "ok":
            if self.brownout:
                self.brownout = False
                actions.append("restore")
            if n_workers > self.min_workers and self._cooled(now):
                self._last_scale = now
                actions.append("scale_down")
        # "warn" holds position: neither direction is justified yet.
        return actions


# ----------------------------------------------------------------------
# Router-side windows
# ----------------------------------------------------------------------


class RouterWindows:
    """Sliding windows over RELAYED outcomes — the fleet-level aggregate
    the SLO engine grades (a client cares about the answer it got, not
    which worker produced it). Same primitives as the worker's own
    windows (obs/window.py), same injectable clock, so tests drive burn
    rates without sleeping."""

    def __init__(self, clock=None):
        self._clock = clock if clock is not None else time.monotonic
        self.latency = obswin.WindowedHistogram(clock=self._clock)
        self.ok = obswin.WindowedCounter(clock=self._clock)
        self.errors = obswin.WindowedCounter(clock=self._clock)
        self.shed = obswin.WindowedCounter(clock=self._clock)

    def observe(self, status: int, latency_ms: float) -> None:
        self.latency.record(latency_ms)
        if status < 400:
            self.ok.add()
        elif status == 429:
            self.shed.add()
        else:
            self.errors.add()

    def sample(self, span_sec: float) -> WindowSample:
        return WindowSample(
            self.latency.merged(span_sec),
            ok=self.ok.total(span_sec),
            errors=self.errors.total(span_sec),
            shed=self.shed.total(span_sec),
        )

    def block(self, span_sec: float = obswin.DEFAULT_WINDOW_SEC) -> dict:
        hist = self.latency.merged(span_sec)
        return {
            "span_sec": span_sec,
            "ok": self.ok.total(span_sec),
            "errors": self.errors.total(span_sec),
            "shed": self.shed.total(span_sec),
            "latency_ms": {
                "count": hist.count,
                "p50": round(hist.quantile(0.50), 3),
                "p90": round(hist.quantile(0.90), 3),
                "p99": round(hist.quantile(0.99), 3),
            },
        }


# ----------------------------------------------------------------------
# One supervised worker
# ----------------------------------------------------------------------


class FleetWorker:
    """Router-side record of one serving worker process (slot +
    generation). Process lifecycle and health are owned by the monitor
    thread; the routing fields (``ready``/``failed``/``inflight``/
    gauges) are shared with the event loop under the router's lock."""

    def __init__(
        self,
        slot: int,
        generation: int,
        port: int,
        proc: "subprocess.Popen",
        health: WorkerHealth,
        hb_file: Path,
    ):
        self.slot = int(slot)
        self.generation = int(generation)
        self.worker_id = worker_id(slot, generation)
        self.port = int(port)
        self.proc = proc
        self.health = health
        self.hb_file = Path(hb_file)
        self.ready = False
        self.failed = False
        self.retiring = False
        self.inflight = 0
        self.queue_depth = 0
        self.latency_p50_ms: Optional[float] = None
        self.replicas = 1
        self.last_stats: Optional[dict] = None
        self.baseline_downgrade: Optional[int] = None
        self.kill_deadline: Optional[float] = None
        self.down_event: Optional[asyncio.Event] = None
        self._last_http_poll = 0.0

    def est_ms(self) -> float:
        """Projected time-to-answer from the last polled gauges: the
        backlog ahead of a new arrival, spread over the worker's
        replicas, at its windowed median latency. Zero (never skip)
        until the worker has served enough to have a median."""
        if not self.latency_p50_ms:
            return 0.0
        waiting = self.queue_depth + self.inflight
        return (waiting / max(1, self.replicas) + 1) * self.latency_p50_ms

    def summary(self) -> dict:
        return {
            "slot": self.slot,
            "generation": self.generation,
            "port": self.port,
            "state": self.health.state,
            "ready": self.ready,
            "inflight": self.inflight,
            "queue_depth": self.queue_depth,
        }


class _ClientSink:
    """Client-side target for the copy-lean /enhance relay.

    Once a worker response head parses, ``begin`` commits the head to
    the client and body chunks are pumped straight through — the router
    never rebuffers the whole answer. ``tee`` collects the chunks ONLY
    when the head callback decided the router cache will store the body;
    ``committed`` tells the dispatch loop a redispatch is no longer
    possible (bytes are on the wire). Event-loop-only state: no lock.
    """

    def __init__(self, writer, head_fn):
        self.writer = writer
        self._head_fn = head_fn
        self.committed = False
        self.tee: Optional[List[bytes]] = None

    def begin(self, status: int, ctype: str, relay, length: int) -> None:
        self.committed = True
        self.tee = self._head_fn(status, ctype, relay, length)


# ----------------------------------------------------------------------
# The router
# ----------------------------------------------------------------------


class FleetRouter:
    """Front router + worker supervisor + SLO control loop.

    Threading model (threadlint-audited): the asyncio event loop (one
    thread) owns client connections and request relays; ONE monitor
    thread owns worker processes, health, and the control loop; the two
    share the worker table and counters under ``self._lock``, with no
    blocking call ever made while holding it. Worker HTTP polls and
    policy pushes happen on the monitor thread between lock sections.
    """

    def __init__(
        self,
        worker_cmd: List[str],
        n_workers: int = 2,
        max_workers: Optional[int] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        late_sec: float = 3.0,
        hang_sec: float = 6.0,
        startup_grace_sec: float = 180.0,
        drain_grace_sec: float = 10.0,
        poll_sec: float = 0.25,
        health_poll_sec: float = 0.5,
        heartbeat_sec: float = 0.5,
        route_retries: int = 2,
        proxy_timeout_sec: float = 120.0,
        grace_sec: float = 30.0,
        slo: Optional[str] = None,
        slo_short_sec: float = obswin.DEFAULT_WINDOW_SEC,
        slo_long_sec: float = obswin.DEFAULT_LONG_WINDOW_SEC,
        slo_hold_sec: float = 60.0,
        scale_cooldown_sec: float = 30.0,
        forecast: bool = True,
        forecast_horizon_sec: float = 30.0,
        forecast_up_sustain: int = 2,
        forecast_down_sustain: int = 6,
        brownout_watermark: int = 1,
        heartbeat_root=None,
        worker_faults: Optional[Dict[Tuple[int, int], str]] = None,
        max_restarts: int = 5,
        backoff_base_sec: float = 0.25,
        backoff_cap_sec: float = 5.0,
        ring_vnodes: int = 64,
        response_cache: int = 0,
        clock=None,
    ):
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        self.worker_cmd = list(worker_cmd)
        self.n_workers = int(n_workers)
        self.max_workers = int(
            max_workers if max_workers is not None else n_workers
        )
        self.host = host
        self.port = int(port)
        self.late_sec = float(late_sec)
        self.hang_sec = float(hang_sec)
        self.startup_grace_sec = float(startup_grace_sec)
        self.drain_grace_sec = float(drain_grace_sec)
        self.poll_sec = float(poll_sec)
        self.health_poll_sec = float(health_poll_sec)
        self.heartbeat_sec = float(heartbeat_sec)
        self.route_retries = int(route_retries)
        self.proxy_timeout_sec = float(proxy_timeout_sec)
        self.grace_sec = float(grace_sec)
        self.brownout_watermark = int(brownout_watermark)
        self.worker_faults = dict(worker_faults or {})
        self.max_restarts = int(max_restarts)
        self.backoff_base_sec = float(backoff_base_sec)
        self.backoff_cap_sec = float(backoff_cap_sec)
        # Control-plane clock (windows, SLO, policy cooldown) is
        # injectable so tests drive burn rates deterministically; health
        # freshness always uses wall time — heartbeat records carry
        # time.time() stamped by another process.
        self._control_clock = clock if clock is not None else time.monotonic
        self._windows = RouterWindows(clock=self._control_clock)
        self.slo_spec = slo
        self.slo_short_sec = float(slo_short_sec)
        self.slo_long_sec = float(slo_long_sec)
        self._slo = (
            SloEngine(
                parse_slo(slo), spec=slo,
                short_sec=slo_short_sec, long_sec=slo_long_sec,
                hold_sec=slo_hold_sec,
            )
            if slo
            else None
        )
        self._policy = FleetPolicy(
            self.n_workers, self.max_workers, cooldown_sec=scale_cooldown_sec
        )
        # Queue-depth forecaster: armed only when the SLO carries a
        # latency objective — its threshold IS the drain-time budget the
        # Little's-law breach depth is computed against. The burn engine
        # stays authoritative for paging and brown-out; the forecaster
        # only moves capacity earlier (monitor thread is the sole
        # caller, so the forecaster needs no lock).
        lat_ms = None
        if forecast and self._slo is not None:
            lats = [
                o.threshold for o in self._slo.objectives
                if o.kind == "latency"
            ]
            lat_ms = min(lats) if lats else None
        self._forecaster = (
            QueueForecaster(
                lat_ms,
                horizon_sec=forecast_horizon_sec,
                up_sustain=forecast_up_sustain,
                down_sustain=forecast_down_sustain,
            )
            if lat_ms is not None
            else None
        )
        # Router-level content-addressed /enhance cache. Keys include a
        # ladder identity of "fleet" rather than the bucket ladder (the
        # router never sees it); invalidated when /admin/reload is
        # broadcast through this front door. Only answers served at the
        # exact requested tier are stored, so a brown-out downgrade can
        # never be replayed to a non-opt-in client.
        self.response_cache = (
            ResponseCache(int(response_cache), ladder_id="fleet")
            if response_cache
            else None
        )
        self._hb_root = Path(
            heartbeat_root
            if heartbeat_root is not None
            else tempfile.mkdtemp(prefix="waternet-fleet-hb-")
        )

        self._lock = threading.Lock()
        self._workers: Dict[int, FleetWorker] = {}  # guarded-by: self._lock
        self._ring = HashRing(ring_vnodes)  # guarded-by: self._lock
        self._events: List[dict] = []  # guarded-by: self._lock
        self._worker_ledger: Dict[str, Dict[str, int]] = {}  # guarded-by: self._lock
        self._routed = {"enhance": 0, "stream": 0}  # guarded-by: self._lock
        self._redispatches = 0  # guarded-by: self._lock
        self._restarts = 0  # guarded-by: self._lock
        self._slot_restarts: Dict[int, int] = {}  # guarded-by: self._lock
        self._pending_spawn: Dict[int, Tuple[int, float]] = {}  # guarded-by: self._lock
        self._fail_at: Dict[int, float] = {}  # guarded-by: self._lock
        self._recovery_last: Optional[float] = None  # guarded-by: self._lock
        self._recovery_max = 0.0  # guarded-by: self._lock
        self._brownout = False  # guarded-by: self._lock
        self._slo_block: Optional[dict] = None  # guarded-by: self._lock
        self._next_slot = self.n_workers  # guarded-by: self._lock
        self._inflight = 0  # guarded-by: self._lock

        self.bound_port: Optional[int] = None
        self.draining = threading.Event()
        self._bound = threading.Event()
        self._drain_flag = False
        self._stop_monitor = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._exit_code: Optional[int] = None
        self._error: Optional[BaseException] = None

    # -- lifecycle -----------------------------------------------------

    def run(self, install_signal_handlers: bool = True) -> int:
        return asyncio.run(self._main(install_signal_handlers))

    def start_background(self, timeout: float = 30.0) -> "FleetRouter":
        def _target():
            try:
                self._exit_code = self.run(install_signal_handlers=False)
            except BaseException as err:  # surfaced by wait_ready/join
                self._error = err
                self._exit_code = 1
                self._bound.set()

        self._thread = threading.Thread(
            target=_target, name=f"{THREAD_PREFIX}-fleet-http", daemon=True
        )
        self._thread.start()
        if not self._bound.wait(timeout):
            raise RuntimeError("fleet router did not bind within the timeout")
        if self._error is not None:
            raise RuntimeError("fleet router failed to start") from self._error
        return self

    def wait_ready(
        self, timeout: float = 120.0, min_ready: Optional[int] = None
    ) -> None:
        """Block until ``min_ready`` workers (default: all initially
        requested) report ready on /healthz."""
        need = self.n_workers if min_ready is None else int(min_ready)
        deadline = time.monotonic() + timeout
        while True:
            if self._error is not None:
                raise RuntimeError(
                    "fleet router died during warmup"
                ) from self._error
            with self._lock:
                ready = sum(1 for w in self._workers.values() if w.ready)
            if ready >= need:
                return
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"only {ready}/{need} workers ready in time"
                )
            time.sleep(0.05)

    def request_drain(self) -> None:
        self._drain_flag = True

    def join(self, timeout: float = 120.0) -> int:
        assert self._thread is not None, "router was not started in background"
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError("fleet router did not exit within the timeout")
        return int(self._exit_code)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.bound_port}"

    # -- worker process management (monitor thread) --------------------

    def _worker_env(self, slot: int, generation: int, gen_dir: Path) -> dict:
        env = dict(os.environ)
        env[ENV_HEARTBEAT_DIR] = str(gen_dir)
        env[ENV_HEARTBEAT_SEC] = str(self.heartbeat_sec)
        env[ENV_WORKER_SLOT] = str(slot)
        env[ENV_WORKER_GENERATION] = str(generation)
        env[ENV_WORKER_ID] = worker_id(slot, generation)
        spec = self.worker_faults.get((slot, generation))
        if spec:
            # Deterministic fault targeting, supervisor-style: exactly
            # the named (slot, generation) gets a plan; everyone else
            # must NOT inherit one from the router's own environment.
            env["WATERNET_FAULTS"] = spec
        else:
            env.pop("WATERNET_FAULTS", None)
        return env

    def _spawn_worker(self, slot: int, generation: int) -> FleetWorker:
        port = _free_port()
        gen_dir = self._hb_root / f"slot-{slot:02d}" / f"gen-{generation:03d}"
        cmd = list(self.worker_cmd) + [
            "--host", "127.0.0.1", "--port", str(port),
        ]
        proc = subprocess.Popen(
            cmd, env=self._worker_env(slot, generation, gen_dir)
        )
        health = WorkerHealth(
            late_sec=self.late_sec,
            hang_sec=self.hang_sec,
            startup_grace_sec=self.startup_grace_sec,
            started_at=time.time(),
            live_phase="serve",
        )
        w = FleetWorker(
            slot, generation, port, proc, health,
            heartbeat_path(gen_dir, slot),
        )
        with self._lock:
            self._workers[slot] = w
            self._worker_ledger.setdefault(
                w.worker_id,
                {"ok": 0, "errors": 0, "shed": 0, "deadline_expired": 0,
                 "streams": 0},
            )
        print(
            f"waternet-fleet: spawned worker {w.worker_id} "
            f"(slot {slot} gen {generation}, pid {proc.pid}, port {port})",
            flush=True,
        )
        return w

    def _log_event(self, now: float, **fields) -> None:
        event = {"at": round(now, 3), **fields}
        with self._lock:
            self._events.append(event)
        print(f"waternet-fleet: {json.dumps(event)}", flush=True)

    def _set_down_event(self, w: FleetWorker) -> None:
        ev, loop = w.down_event, self._loop
        if ev is not None and loop is not None:
            try:
                loop.call_soon_threadsafe(ev.set)
            except RuntimeError:
                pass  # loop already closed (shutdown race)

    def _fail_worker(self, w: FleetWorker, now: float, reason: str) -> None:
        """Declare one worker failed: stop routing to it immediately
        (its ring arc remaps, in-flight relays abort and re-dispatch),
        then drain/SIGKILL on the monitor's schedule."""
        with self._lock:
            w.failed = True
            w.ready = False
            self._ring.remove(w.slot)
            self._fail_at.setdefault(w.slot, now)
        self._set_down_event(w)
        self._log_event(
            now, event="worker_failed", worker=w.worker_id,
            reason=reason, state=w.health.state,
        )
        if w.proc.poll() is None:
            # Drain first (SIGTERM = the worker's own graceful path);
            # the monitor SIGKILLs past the grace window. A wedged event
            # loop never acts on SIGTERM — that is what the window is for.
            try:
                w.proc.send_signal(signal.SIGTERM)
            except OSError:
                pass
            w.kill_deadline = now + self.drain_grace_sec

    def _reap_and_relaunch(self, w: FleetWorker, now: float) -> None:
        """Once a failed worker's process is gone, schedule the slot's
        next generation (with backoff; budget-bounded)."""
        with self._lock:
            restarts = self._slot_restarts.get(w.slot, 0) + 1
            self._slot_restarts[w.slot] = restarts
            self._restarts += 1
            if restarts > self.max_restarts:
                del self._workers[w.slot]
                abandoned = True
            else:
                delay = backoff_sec(
                    self.backoff_base_sec, self.backoff_cap_sec, restarts
                )
                self._pending_spawn[w.slot] = (w.generation + 1, now + delay)
                del self._workers[w.slot]
                abandoned = False
        if abandoned:
            self._log_event(
                now, event="slot_abandoned", slot=w.slot,
                restarts=restarts,
            )
        else:
            self._log_event(
                now, event="worker_relaunching", slot=w.slot,
                generation=w.generation + 1,
            )

    def _http_json(
        self, port: int, method: str, path: str, payload=None,
        timeout: float = 1.0,
    ) -> Tuple[Optional[int], Optional[dict]]:
        """Blocking worker-control HTTP from the monitor thread. A hung
        worker times out — never call this holding the lock."""
        body = b"" if payload is None else json.dumps(payload).encode()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
        try:
            conn.request(
                method, path, body=body,
                headers={"Content-Type": "application/json"},
            )
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read() or b"{}")
        except (OSError, ValueError, http.client.HTTPException):
            return None, None
        finally:
            conn.close()

    def _apply_policy(self, w: FleetWorker, watermark) -> None:
        self._http_json(
            w.port, "POST", "/admin/policy",
            {"downgrade_watermark": watermark},
        )

    def _note_ready(self, w: FleetWorker, now: float) -> None:
        # Baseline policy captured BEFORE the worker joins the ring, so
        # a brown-out restore always has a value to restore to.
        _, policy = self._http_json(w.port, "POST", "/admin/policy", {})
        if policy:
            w.baseline_downgrade = policy.get("policy", {}).get(
                "downgrade_watermark"
            )
        with self._lock:
            brownout = self._brownout
        if brownout:
            self._apply_policy(w, self.brownout_watermark)
        recovery = None
        with self._lock:
            w.ready = True
            self._ring.add(w.slot)
            fail_t = self._fail_at.pop(w.slot, None)
            if fail_t is not None:
                recovery = now - fail_t
                self._recovery_last = recovery
                self._recovery_max = max(self._recovery_max, recovery)
        event = {"event": "worker_ready", "worker": w.worker_id}
        if recovery is not None:
            event["recovery_sec"] = round(recovery, 3)
        self._log_event(now, **event)

    def _poll_worker_http(self, w: FleetWorker, now: float) -> None:
        if now - w._last_http_poll < self.health_poll_sec:
            return
        w._last_http_poll = now
        timeout = max(0.2, min(1.0, self.hang_sec / 2))
        status, health = self._http_json(
            w.port, "GET", "/healthz", timeout=timeout
        )
        if not w.ready and status is not None and health is not None:
            if health.get("ready"):
                self._note_ready(w, now)
        status, stats = self._http_json(
            w.port, "GET", "/stats", timeout=timeout
        )
        if status == 200 and stats is not None:
            lat = stats.get("latency_ms_window") or stats.get("latency_ms")
            with self._lock:
                w.last_stats = stats
                w.queue_depth = int(stats.get("queue_depth", 0))
                w.replicas = int(stats.get("replicas", 1))
                if isinstance(lat, dict) and lat.get("p50"):
                    w.latency_p50_ms = float(lat["p50"])

    def _supervise_tick(self, now: float) -> None:
        with self._lock:
            workers = list(self._workers.values())
            pending = dict(self._pending_spawn)
        # Deferred relaunches whose backoff expired.
        for slot, (generation, t_spawn) in pending.items():
            if now >= t_spawn:
                with self._lock:
                    self._pending_spawn.pop(slot, None)
                self._spawn_worker(slot, generation)
        for w in workers:
            rc = w.proc.poll()
            if w.retiring:
                # Scale-down drain: reap on exit, SIGKILL past grace.
                if rc is not None:
                    with self._lock:
                        self._workers.pop(w.slot, None)
                    self._log_event(
                        now, event="worker_retired", worker=w.worker_id,
                        exit_code=rc,
                    )
                elif w.kill_deadline is not None and now >= w.kill_deadline:
                    try:
                        w.proc.kill()
                    except OSError:
                        pass
                continue
            if w.failed:
                if rc is not None:
                    self._reap_and_relaunch(w, now)
                elif w.kill_deadline is not None and now >= w.kill_deadline:
                    try:
                        w.proc.kill()
                    except OSError:
                        pass
                    w.kill_deadline = now + self.drain_grace_sec
                continue
            record = read_heartbeat(w.hb_file)
            if record is not None and record.get("generation") == w.generation:
                w.health.note_beat(record)
            state = w.health.observe(time.time(), exit_code=rc)
            if w.health.failed:
                self._fail_worker(
                    w, now,
                    reason="exit" if state == "dead" else "heartbeat",
                )
                continue
            self._poll_worker_http(w, now)
        self._control_tick(now)

    def _monitor_loop(self) -> None:
        # Initial fleet: spawned from the monitor thread so ALL process
        # lifecycle lives on one thread (supervisor.py's discipline).
        for slot in range(self.n_workers):
            self._spawn_worker(slot, 0)
        while not self._stop_monitor.wait(self.poll_sec):
            self._supervise_tick(self._control_clock())

    # -- SLO control loop ----------------------------------------------

    def _paging_objective(self, slo_block: dict) -> Optional[str]:
        for row in slo_block.get("objectives", ()):
            if row.get("state") == "page":
                return row.get("objective")
        return None

    def _control_tick(self, now: float) -> None:
        """One closed-loop evaluation: windows -> SLO -> policy ->
        actions. Called by the monitor each tick; tests call it directly
        with a fake clock (no sleeps, deterministic transitions)."""
        if self._slo is None:
            return
        short = self._windows.sample(self.slo_short_sec)
        long = self._windows.sample(self.slo_long_sec)
        block = self._slo.evaluate(now, short, long)
        with self._lock:
            self._slo_block = block
            n_live = len(
                [w for w in self._workers.values()
                 if not w.failed and not w.retiring]
            ) + len(self._pending_spawn)
        for tr in block["transitions"]:
            self._log_event(
                now, event="slo_transition", objective=tr["objective"],
                **{"from": tr["from"], "to": tr["to"]},
            )
        objective = self._paging_objective(block) or block["state"]
        actions = self._policy.step(now, block["state"], n_live)
        for action in actions:
            if action == "brownout":
                self._apply_brownout(now, objective)
            elif action == "restore":
                self._apply_restore(now, objective)
            elif action == "scale_up":
                self._apply_scale_up(now, objective, n_live)
            elif action == "scale_down":
                self._apply_scale_down(now, objective, n_live)
        self._forecast_tick(now, block, n_live, actions)

    def _forecast_tick(
        self, now: float, block: dict, n_live: int, burn_actions: List[str]
    ) -> None:
        """Predictive half of the control loop: aggregate polled queue
        depth -> forecaster -> early scale hint. Runs AFTER the burn
        policy so a paging fleet is already handled; forecast actions
        share the policy's cooldown and never touch brown-out."""
        if self._forecaster is None:
            return
        with self._lock:
            depth = sum(
                w.queue_depth + w.inflight
                for w in self._workers.values()
                if not w.failed and not w.retiring
            )
        span = max(self.slo_short_sec, 1e-6)
        service_rate = self._windows.ok.total(self.slo_short_sec) / span
        hint = self._forecaster.step(now, depth, service_rate)
        if hint is None or any(
            a in ("scale_up", "scale_down") for a in burn_actions
        ):
            return
        if (
            hint == "scale_up"
            and block["state"] != "page"
            and n_live < self.max_workers
            and self._policy.cooled(now)
        ):
            self._policy.note_scale(now)
            self._apply_scale_up(
                now, "queue_forecast", n_live, event="forecast_scale_up",
            )
        elif (
            # "warn" is included: the burn policy holds position there,
            # so a sustained-low forecast is the only voice that can
            # shrink an over-provisioned warn-state fleet.
            hint == "scale_down"
            and block["state"] in ("ok", "warn")
            and not self._policy.brownout
            and n_live > self._policy.min_workers
            and self._policy.cooled(now)
        ):
            self._policy.note_scale(now)
            self._apply_scale_down(
                now, "queue_forecast", n_live, event="forecast_scale_down",
            )

    def _ready_workers(self) -> List[FleetWorker]:
        with self._lock:
            return [
                w for w in self._workers.values()
                if w.ready and not w.failed and not w.retiring
            ]

    def _apply_brownout(self, now: float, objective: str) -> None:
        with self._lock:
            self._brownout = True
        for w in self._ready_workers():
            self._apply_policy(w, self.brownout_watermark)
        self._log_event(
            now, event="brownout", objective=objective,
            downgrade_watermark=self.brownout_watermark,
        )

    def _apply_restore(self, now: float, objective: str) -> None:
        with self._lock:
            self._brownout = False
        for w in self._ready_workers():
            self._apply_policy(w, w.baseline_downgrade)
        self._log_event(now, event="restore", objective=objective)

    def _apply_scale_up(
        self, now: float, objective: str, n_live: int,
        event: str = "scale_up",
    ) -> None:
        with self._lock:
            slot = self._next_slot
            self._next_slot += 1
        self._log_event(
            now, event=event, objective=objective,
            workers=n_live + 1, slot=slot,
        )
        # The brown-out policy (if active) lands on the new worker when
        # it reports ready — _note_ready re-applies it.
        self._spawn_worker(slot, 0)

    def _apply_scale_down(
        self, now: float, objective: str, n_live: int,
        event: str = "scale_down",
    ) -> None:
        # Retire the highest live slot: deterministic choice, and the
        # base slots (0..n_workers-1) are never the ones retired.
        with self._lock:
            candidates = [
                w for w in self._workers.values()
                if not w.failed and not w.retiring
                and w.slot >= self.n_workers
            ]
            if not candidates:
                return
            w = max(candidates, key=lambda x: x.slot)
            w.retiring = True
            w.ready = False
            self._ring.remove(w.slot)
        self._set_down_event(w)
        w.kill_deadline = now + self.grace_sec
        try:
            w.proc.send_signal(signal.SIGTERM)
        except OSError:
            pass
        self._log_event(
            now, event=event, objective=objective,
            workers=n_live - 1, worker=w.worker_id,
        )

    # -- stats ---------------------------------------------------------

    def _account_relay(self, w: FleetWorker, status: int) -> None:
        bucket = (
            "ok" if status < 400
            else "shed" if status == 429
            else "deadline_expired" if status == 504
            else "errors"
        )
        with self._lock:
            self._routed["enhance"] += 1
            self._worker_ledger[w.worker_id][bucket] += 1

    def summary(self) -> dict:
        win = self._windows.block(self.slo_short_sec)
        with self._lock:
            events = list(self._events)
            fleet = {
                "workers": len(self._workers),
                "ready": sum(1 for w in self._workers.values() if w.ready),
                "max_workers": self.max_workers,
                "restarts": self._restarts,
                "redispatches": self._redispatches,
                "routed": dict(self._routed),
                "per_worker": {
                    wid: dict(c) for wid, c in self._worker_ledger.items()
                },
                "recovery_sec_last": (
                    round(self._recovery_last, 3)
                    if self._recovery_last is not None else None
                ),
                "recovery_sec_max": round(self._recovery_max, 3),
                "brownout": self._brownout,
                "ring": self._ring.members(),
                "response_cache": (
                    self.response_cache.counters()
                    if self.response_cache is not None
                    else empty_cache_block()
                ),
                "forecast": (
                    self._forecaster.block()
                    if self._forecaster is not None
                    else empty_forecast_block()
                ),
            }
            workers = {
                w.worker_id: w.summary() for w in self._workers.values()
            }
            worker_stats = {
                w.worker_id: w.last_stats
                for w in self._workers.values()
                if w.last_stats is not None
            }
            slo_block = self._slo_block
        fleet["scale_events"] = [
            e for e in events
            if e.get("event") in (
                "scale_up", "scale_down",
                "forecast_scale_up", "forecast_scale_down",
            )
        ]
        fleet["events"] = events[-100:]
        return {
            "fleet": fleet,
            "workers": workers,
            "worker_stats": worker_stats,
            "window": win,
            "slo": slo_block,
        }

    # -- HTTP plumbing (mirrors serving/server.py) ---------------------

    async def _main(self, install_signals: bool) -> int:
        from waternet_tpu_torch.resilience.preemption import PreemptionGuard

        guard = PreemptionGuard() if install_signals else None
        if guard is not None:
            guard.__enter__()
        server = None
        try:
            self._loop = asyncio.get_running_loop()
            server = await asyncio.start_server(
                self._handle_connection, self.host, self.port
            )
            self.bound_port = server.sockets[0].getsockname()[1]
            self._bound.set()
            print(
                f"waternet-fleet: listening on http://{self.host}:"
                f"{self.bound_port}",
                flush=True,
            )
            self._monitor = threading.Thread(
                target=self._monitor_loop,
                name=f"{THREAD_PREFIX}-fleet-monitor",
                daemon=True,
            )
            self._monitor.start()

            while not (
                self._drain_flag or (guard is not None and guard.requested)
            ):
                await asyncio.sleep(0.05)

            # Drain ordering (docs/SERVING.md "Fleet"): the ROUTER stops
            # admitting first (503 + close), relays in flight finish,
            # THEN workers are asked to drain — a worker must never
            # disappear under a relay the router already accepted.
            self.draining.set()
            print("waternet-fleet: draining", flush=True)
            deadline = time.monotonic() + self.grace_sec
            clean = False
            while time.monotonic() < deadline:
                with self._lock:
                    inflight = self._inflight
                if inflight == 0:
                    clean = True
                    break
                await asyncio.sleep(0.02)
            await asyncio.sleep(0.05)
            loop = asyncio.get_running_loop()
            workers_clean = await loop.run_in_executor(
                None, self._shutdown_workers
            )
            return 0 if (clean and workers_clean) else 1
        finally:
            self._stop_monitor.set()
            if self._monitor is not None:
                self._monitor.join(timeout=10.0)
            if server is not None:
                server.close()
                await server.wait_closed()
            # Belt and braces: no worker process survives the router.
            with self._lock:
                leftovers = list(self._workers.values())
            for w in leftovers:
                if w.proc.poll() is None:
                    try:
                        w.proc.kill()
                        w.proc.wait(timeout=5.0)
                    except OSError:
                        pass
            if guard is not None:
                guard.__exit__(None, None, None)
            print(json.dumps(self.summary()), flush=True)

    def _shutdown_workers(self) -> bool:
        """Drain every worker (SIGTERM -> grace -> SIGKILL); True when
        all live workers exited cleanly. Runs in an executor thread
        after the router's own drain, monitor already stopping."""
        self._stop_monitor.set()
        if self._monitor is not None:
            self._monitor.join(timeout=10.0)
        with self._lock:
            workers = list(self._workers.values())
        for w in workers:
            if w.proc.poll() is None:
                try:
                    w.proc.send_signal(signal.SIGTERM)
                except OSError:
                    pass
        clean = True
        deadline = time.monotonic() + self.drain_grace_sec + self.grace_sec
        for w in workers:
            remaining = max(0.1, deadline - time.monotonic())
            try:
                rc = w.proc.wait(timeout=remaining)
            except subprocess.TimeoutExpired:
                try:
                    w.proc.kill()
                    w.proc.wait(timeout=5.0)
                except OSError:
                    pass
                rc = w.proc.poll()
            if rc != 0 and not (w.failed or w.retiring):
                clean = False
        return clean

    async def _handle_connection(self, reader, writer):
        try:
            while True:
                req = await self._read_request(reader)
                if req is None:
                    break
                keep = await self._dispatch(req, reader, writer)
                await writer.drain()
                if not keep:
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _read_request(
        self, reader
    ) -> Optional[Tuple[str, str, dict, bytes]]:
        try:
            line = await reader.readline()
        except (ConnectionError, asyncio.LimitOverrunError, ValueError):
            return None
        if not line or not line.strip():
            return None
        parts = line.decode("latin-1").strip().split()
        if len(parts) < 2:
            return None
        method, target = parts[0].upper(), parts[1]
        headers = {}
        while True:
            try:
                line = await reader.readline()
            except (ConnectionError, asyncio.LimitOverrunError, ValueError):
                return None
            if not line or line in (b"\r\n", b"\n"):
                break
            name, _, value = line.decode("latin-1").partition(":")
            headers[name.strip().lower()] = value.strip()
        length = _content_length(headers)
        if length > MAX_BODY_BYTES:
            return (method, target, headers, b"")
        body = await reader.readexactly(length) if length else b""
        return method, target.split("?", 1)[0], headers, body

    def _respond(
        self, writer, status, body, ctype="application/json", extra=(),
        close=False,
    ) -> bool:
        head = (
            f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\n"
        )
        for name, value in extra:
            head += f"{name}: {value}\r\n"
        if close:
            head += "Connection: close\r\n"
        writer.write(head.encode("latin-1") + b"\r\n" + body)
        return not close

    def _json(self, writer, status, payload, extra=(), close=False) -> bool:
        return self._respond(
            writer, status, json.dumps(payload).encode(), extra=extra,
            close=close,
        )

    async def _dispatch(self, req, reader, writer) -> bool:
        method, path, headers, body = req
        want_close = headers.get("connection", "").lower() == "close"
        req_id = _request_id(headers)
        rid = (("X-Request-Id", req_id),)
        if _content_length(headers) > MAX_BODY_BYTES:
            return self._json(
                writer, 413, {"error": "payload too large"}, extra=rid,
                close=True,
            )
        if path == "/stream":
            if method != "POST":
                return self._json(
                    writer, 405,
                    {"error": "POST a length-prefixed frame stream "
                     "to /stream"},
                    extra=rid,
                )
            await self._stream(headers, reader, writer, req_id)
            return False
        if path == "/healthz":
            return self._healthz(writer) and not want_close
        if path == "/stats":
            return (
                self._json(writer, 200, self.summary()) and not want_close
            )
        if path == "/metrics":
            return (
                self._respond(
                    writer, 200,
                    render_fleet_prometheus(self.summary()).encode(),
                    ctype="text/plain; version=0.0.4; charset=utf-8",
                )
                and not want_close
            )
        if path in ("/enhance", "/v1/enhance"):
            if method != "POST":
                return self._json(
                    writer, 405,
                    {"error": "POST image bytes to /enhance"}, extra=rid,
                )
            return (
                await self._enhance(path, headers, body, writer, req_id)
                and not want_close
            )
        if path == "/admin/reload":
            if method != "POST":
                return self._json(
                    writer, 405,
                    {"error": 'POST {"weights": path} to /admin/reload'},
                    extra=rid,
                )
            return (
                await self._admin_reload(headers, body, writer, req_id)
                and not want_close
            )
        return self._json(writer, 404, {"error": f"no route {path}"},
                          extra=rid)

    def _healthz(self, writer) -> bool:
        with self._lock:
            workers = {
                w.worker_id: w.summary() for w in self._workers.values()
            }
            n_ready = sum(1 for w in self._workers.values() if w.ready)
            any_sick = any(
                w.failed or w.health.state in ("late",)
                for w in self._workers.values()
            )
            brownout = self._brownout
            slo_block = self._slo_block
        payload = {
            "ready": n_ready > 0 and not self.draining.is_set(),
            "draining": self.draining.is_set(),
            "workers": workers,
            "ready_workers": n_ready,
            "brownout": brownout,
        }
        if slo_block is not None:
            payload["slo"] = {
                "grade": slo_block["grade"],
                "state": slo_block["state"],
                "spec": slo_block["spec"],
            }
        if self.draining.is_set():
            payload["status"] = "draining"
            return self._json(writer, 503, payload)
        if n_ready == 0:
            payload["status"] = "unhealthy"
            return self._json(writer, 503, payload)
        slo_degraded = (
            slo_block is not None and slo_block["grade"] == "degraded"
        )
        payload["status"] = (
            "degraded" if (any_sick or slo_degraded or brownout) else "ok"
        )
        return self._json(writer, 200, payload)

    # -- /enhance relay ------------------------------------------------

    def _pick_worker(
        self, tried, budget_ms: Optional[float]
    ) -> Tuple[Optional[FleetWorker], bool]:
        """Least-loaded ready worker not yet tried; deadline-aware —
        workers whose projected answer time blows the budget are
        skipped. Returns (worker, any_skipped_on_deadline)."""
        skipped = False
        with self._lock:
            cands = [
                w for w in self._workers.values()
                if w.ready and not w.failed and not w.retiring
                and w.slot not in tried
            ]
        if budget_ms is not None:
            fitting = [w for w in cands if w.est_ms() <= budget_ms]
            skipped = len(fitting) < len(cands)
            cands = fitting
        if not cands:
            return None, skipped
        w = min(cands, key=lambda w: (w.inflight, w.queue_depth, w.slot))
        return w, skipped

    async def _relay_enhance(
        self, w: FleetWorker, path: str, headers: dict, body: bytes,
        req_id: str, sink: Optional[_ClientSink] = None,
    ):
        """One relay attempt. Returns (status, ctype, relay_headers,
        body) or None on a demonstrable transport failure (connect
        error, torn response, worker declared down mid-read, per-attempt
        timeout) — the caller re-dispatches those; worker ANSWERS always
        relay. With a ``sink``, the body streams to the client as it
        arrives (returned body is None) and ``sink.committed`` marks the
        point of no redispatch."""
        try:
            wreader, wwriter = await asyncio.open_connection(
                "127.0.0.1", w.port
            )
        except OSError:
            return None
        try:
            head = f"POST {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
            fwd = dict(headers)
            fwd["x-request-id"] = req_id
            for name in _FORWARD_HEADERS:
                if name in fwd:
                    head += f"{name}: {fwd[name]}\r\n"
            head += (
                f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n"
            )
            wwriter.write(head.encode("latin-1") + body)
            await wwriter.drain()
            if w.down_event is None:
                w.down_event = asyncio.Event()
            read = asyncio.ensure_future(
                self._read_worker_response(wreader, sink)
            )
            down = asyncio.ensure_future(w.down_event.wait())
            done, pending = await asyncio.wait(
                {read, down},
                timeout=self.proxy_timeout_sec,
                return_when=asyncio.FIRST_COMPLETED,
            )
            for t in pending:
                t.cancel()
            if down in done and read not in done:
                read.cancel()
                return None
            if read not in done:
                return None  # per-attempt timeout: treat as failed worker
            try:
                return read.result()
            except (
                ConnectionError, asyncio.IncompleteReadError, OSError,
                ValueError,
            ):
                return None
        except (ConnectionError, OSError):
            return None
        finally:
            try:
                wwriter.close()
            except Exception:
                pass

    async def _read_worker_response(
        self, wreader, sink: Optional[_ClientSink] = None
    ):
        line = await wreader.readline()
        parts = line.decode("latin-1").split()
        if len(parts) < 2:
            return None
        status = int(parts[1])
        headers = {}
        while True:
            line = await wreader.readline()
            if not line or line in (b"\r\n", b"\n"):
                break
            name, _, value = line.decode("latin-1").partition(":")
            headers[name.strip().lower()] = value.strip()
        length = _content_length(headers)
        relay = tuple(
            (name.title(), headers[name])
            for name in _RELAY_HEADERS
            if name in headers and name != "content-type"
        )
        ctype = headers.get("content-type", "application/json")
        if sink is None:
            body = await wreader.readexactly(length) if length else b""
            return status, ctype, relay, body
        # Copy-lean path: the head is committed to the client the moment
        # it parses, then the body pumps through in 64 KiB chunks (the
        # /stream relay's unit) — the router never holds the full
        # answer. Tee-accumulate only when the sink's head callback
        # asked for the bytes back (a router cache put).
        sink.begin(status, ctype, relay, length)
        remaining = length
        while remaining:
            chunk = await wreader.read(min(remaining, 1 << 16))
            if not chunk:
                raise asyncio.IncompleteReadError(b"", remaining)
            if sink.tee is not None:
                sink.tee.append(chunk)
            sink.writer.write(chunk)
            await sink.writer.drain()
            remaining -= len(chunk)
        return status, ctype, relay, None

    def _commit_relay_head(
        self, writer, status: int, ctype: str, relay, length: int,
        cache_key, req_tier: str, rid,
    ) -> Optional[List[bytes]]:
        """Write the relayed response head to the client (same bytes
        ``_respond`` would have produced) and decide the tee: a chunk
        list when the router cache will store this body, else None."""
        extra = relay
        if cache_key is not None and not any(
                n == "X-Cache" for n, _ in extra):
            # Router cache enabled but this answer came from a worker
            # (and the worker didn't stamp its own cache state): stamp
            # the router-level miss.
            extra = extra + (("X-Cache", "miss"),)
        if not any(n == "X-Request-Id" for n, _ in extra):
            extra = extra + rid
        head = (
            f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {length}\r\n"
        )
        for name, value in extra:
            head += f"{name}: {value}\r\n"
        writer.write(head.encode("latin-1") + b"\r\n")
        if cache_key is not None and status == 200:
            served = next(
                (v for n, v in relay if n == "X-Tier-Served"), None
            )
            if served is not None and served.strip().lower() == req_tier:
                return []
        return None

    async def _enhance(self, path, headers, body, writer, req_id) -> bool:
        rid = (("X-Request-Id", req_id),)
        if self.draining.is_set():
            return self._json(
                writer, 503, {"error": "draining"}, extra=rid, close=True,
            )
        budget_ms = None
        raw = headers.get("x-deadline-ms")
        if raw is not None:
            try:
                budget_ms = float(raw)
            except ValueError:
                budget_ms = None  # forwarded anyway; the worker 400s it
        t0 = time.monotonic()
        req_tier = headers.get("x-tier", "quality").strip().lower()
        cache_key = None
        if self.response_cache is not None:
            cache_key = self.response_cache.key(body, req_tier)
            cached = self.response_cache.get(cache_key)
            if cached is not None:
                # Replay the stored worker answer without touching a
                # worker. Cached relay headers were stripped of the
                # original X-Request-Id / X-Cache at store time, so the
                # replay carries this request's id and a "hit" stamp.
                c_ctype, c_relay, c_body = cached
                self._windows.observe(200, (time.monotonic() - t0) * 1e3)
                return self._respond(
                    writer, 200, c_body, ctype=c_ctype,
                    extra=c_relay + (("X-Cache", "hit"),) + rid,
                )
        with self._lock:
            self._inflight += 1
        tried: set = set()
        skipped_any = False
        try:
            for _ in range(self.route_retries + 1):
                remaining = (
                    None if budget_ms is None
                    else budget_ms - (time.monotonic() - t0) * 1e3
                )
                w, skipped = self._pick_worker(tried, remaining)
                skipped_any = skipped_any or skipped
                if w is None:
                    break
                with self._lock:
                    w.inflight += 1
                sink = _ClientSink(
                    writer,
                    lambda s, c, r, n: self._commit_relay_head(
                        writer, s, c, r, n, cache_key, req_tier, rid
                    ),
                )
                try:
                    answer = await self._relay_enhance(
                        w, path, headers, body, req_id, sink=sink
                    )
                finally:
                    with self._lock:
                        w.inflight -= 1
                if answer is None:
                    if sink.committed:
                        # The head (and possibly part of the body) is
                        # already on the wire: a redispatch would splice
                        # two answers. Account the torn relay and drop
                        # the connection — the client sees truncation,
                        # exactly what a direct worker death looks like.
                        self._windows.observe(
                            500, (time.monotonic() - t0) * 1e3
                        )
                        self._account_relay(w, 500)
                        return False
                    # Demonstrable transport failure before any byte
                    # reached the client: the worker died or wedged
                    # under this relay. Bounded re-dispatch, same
                    # X-Request-Id — byte-identical by replica invariance.
                    tried.add(w.slot)
                    with self._lock:
                        self._redispatches += 1
                    continue
                status, _ctype, relay, _streamed = answer
                latency_ms = (time.monotonic() - t0) * 1e3
                self._windows.observe(status, latency_ms)
                self._account_relay(w, status)
                if sink.tee is not None:
                    # The head callback teed the body for the router
                    # cache (200, exact requested tier — a brown-out
                    # downgrade is never replayed later).
                    stored_relay = tuple(
                        (n, v) for n, v in relay
                        if n not in ("X-Request-Id", "X-Cache")
                    )
                    self.response_cache.put(
                        cache_key,
                        (_ctype, stored_relay, b"".join(sink.tee)),
                    )
                return True
            # Out of candidates (or retries): the router answers, id
            # echoed, so the client's correlation never dangles.
            self._windows.observe(504 if skipped_any else 503, 0.0)
            if skipped_any:
                return self._json(
                    writer, 504,
                    {"error": "no worker can meet the deadline",
                     "budget_ms": budget_ms},
                    extra=rid,
                )
            return self._json(
                writer, 503,
                {"error": "no healthy worker"},
                extra=(("Retry-After", "1"),) + rid,
            )
        finally:
            with self._lock:
                self._inflight -= 1

    async def _admin_reload(self, headers, body, writer, req_id) -> bool:
        """Broadcast ``POST /admin/reload`` to every ready worker, then
        invalidate the router response cache. The aggregate answer is
        200 only when every ready worker reloaded; per-worker replies
        are included so a mixed fleet is diagnosable from one call.
        Cache invalidation happens even on partial failure — a stale
        replay is worse than a redundant recompute."""
        rid = (("X-Request-Id", req_id),)
        if self.draining.is_set():
            return self._json(
                writer, 503, {"error": "draining"}, extra=rid, close=True,
            )
        with self._lock:
            workers = [
                w for w in self._workers.values()
                if w.ready and not w.failed and not w.retiring
            ]
        if not workers:
            return self._json(
                writer, 503, {"error": "no healthy worker"},
                extra=(("Retry-After", "1"),) + rid,
            )
        results = {}
        all_ok = True
        for w in workers:
            answer = await self._relay_enhance(
                w, "/admin/reload", headers, body, req_id
            )
            if answer is None:
                results[w.worker_id] = {"error": "relay failed"}
                all_ok = False
                continue
            status, _ctype, _relay, resp_body = answer
            try:
                payload = json.loads(resp_body) if resp_body else {}
            except ValueError:
                payload = {"error": "unparseable worker reply"}
            if not isinstance(payload, dict):
                payload = {"reply": payload}
            payload["status"] = status
            results[w.worker_id] = payload
            all_ok = all_ok and status == 200
        if self.response_cache is not None:
            self.response_cache.invalidate()
        return self._json(
            writer, 200 if all_ok else 502,
            {"reloaded": all_ok, "workers": results},
            extra=rid,
        )

    # -- /stream relay -------------------------------------------------

    async def _stream(self, headers, reader, writer, req_id) -> None:
        rid = (("X-Request-Id", req_id),)
        if self.draining.is_set():
            self._json(writer, 503, {"error": "draining"}, extra=rid,
                       close=True)
            return
        with self._lock:
            slot = self._ring.lookup(req_id)
            w = self._workers.get(slot) if slot is not None else None
            pinnable = (
                w is not None and w.ready and not w.failed
                and not w.retiring
            )
            if pinnable:
                w.inflight += 1
                self._routed["stream"] += 1
                self._worker_ledger[w.worker_id]["streams"] += 1
        if not pinnable:
            self._json(
                writer, 503,
                {"error": "pinned worker unavailable"},
                extra=(("Retry-After", "1"),) + rid, close=True,
            )
            return
        try:
            try:
                wreader, wwriter = await asyncio.open_connection(
                    "127.0.0.1", w.port
                )
            except OSError:
                self._json(
                    writer, 503,
                    {"error": "pinned worker unavailable"},
                    extra=(("Retry-After", "1"),) + rid, close=True,
                )
                return
            try:
                head = "POST /stream HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                fwd = dict(headers)
                fwd["x-request-id"] = req_id
                for name in _FORWARD_HEADERS:
                    if name in fwd:
                        head += f"{name}: {fwd[name]}\r\n"
                head += "Connection: close\r\n\r\n"
                wwriter.write(head.encode("latin-1"))
                await wwriter.drain()
                # Raw byte relay both ways from here: the worker's
                # response head (and its in-order frame records) pass
                # through verbatim, so stream bit-identity is the
                # worker's property, untouched by the hop.
                up = asyncio.ensure_future(
                    self._pump(reader, wwriter)
                )
                down = asyncio.ensure_future(
                    self._pump(wreader, writer)
                )
                # The session is over when the WORKER closes (it sends
                # the end-of-stream record and half of the pair ends);
                # the client-side pump is then cancelled.
                await down
                up.cancel()
                try:
                    await up
                except (asyncio.CancelledError, ConnectionError, OSError):
                    pass
            finally:
                try:
                    wwriter.close()
                except Exception:
                    pass
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            with self._lock:
                w.inflight -= 1

    @staticmethod
    async def _pump(src_reader, dst_writer) -> None:
        try:
            while True:
                chunk = await src_reader.read(1 << 16)
                if not chunk:
                    break
                dst_writer.write(chunk)
                await dst_writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError, OSError):
            pass


# ----------------------------------------------------------------------
# Prometheus projection (fleet vocabulary — the worker metrics live on
# each worker's own /metrics; the router exports the FLEET view).
# ----------------------------------------------------------------------


def render_fleet_prometheus(summary: dict) -> str:
    fleet = summary["fleet"]
    lines: List[str] = []

    def metric(name, mtype, help_text, samples):
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {mtype}")
        for labels, value in samples:
            if labels:
                body = ",".join(f'{k}="{v}"' for k, v in labels.items())
                lines.append(f"{name}{{{body}}} {value}")
            else:
                lines.append(f"{name} {value}")

    metric("waternet_fleet_workers", "gauge", "Workers in the fleet table",
           [(None, fleet["workers"])])
    metric("waternet_fleet_workers_ready", "gauge", "Workers serving",
           [(None, fleet["ready"])])
    metric("waternet_fleet_restarts_total", "counter",
           "Worker relaunches (fresh generations)",
           [(None, fleet["restarts"])])
    metric("waternet_fleet_redispatch_total", "counter",
           "Relays re-dispatched after a worker failure",
           [(None, fleet["redispatches"])])
    metric("waternet_fleet_routed_total", "counter",
           "Requests routed, by route",
           [({"route": k}, v) for k, v in sorted(fleet["routed"].items())])
    metric("waternet_fleet_scale_events_total", "counter",
           "Scale-up/down events", [(None, len(fleet["scale_events"]))])
    metric("waternet_fleet_brownout", "gauge",
           "1 while the brown-out policy shift is applied",
           [(None, 1 if fleet["brownout"] else 0)])
    metric("waternet_fleet_recovery_sec_max", "gauge",
           "Slowest failure-to-ready worker recovery",
           [(None, fleet["recovery_sec_max"])])
    cache = fleet.get("response_cache")
    if cache:
        metric("waternet_fleet_response_cache_enabled", "gauge",
               "1 when the router content-addressed /enhance cache is on",
               [(None, 1 if cache["enabled"] else 0)])
        metric("waternet_fleet_response_cache_hits_total", "counter",
               "Router /enhance answers replayed from cache",
               [(None, cache["hits"])])
        metric("waternet_fleet_response_cache_misses_total", "counter",
               "Router /enhance cache lookups that fell through",
               [(None, cache["misses"])])
        metric("waternet_fleet_response_cache_evictions_total", "counter",
               "Router cache entries evicted by the LRU bound",
               [(None, cache["evictions"])])
        metric("waternet_fleet_response_cache_entries", "gauge",
               "Router cache entries currently held",
               [(None, cache["entries"])])
    forecast = fleet.get("forecast") or {}
    if forecast.get("depth") is not None:
        metric("waternet_fleet_forecast_depth", "gauge",
               "Forecast aggregate queue depth at the scaling horizon",
               [(None, forecast["depth"])])
        metric("waternet_fleet_forecast_breach_eta_sec", "gauge",
               "Seconds until the queue-depth forecast breaches the "
               "latency objective (absent: no breach on the horizon)",
               [(None, forecast["breach_eta_sec"])]
               if forecast.get("breach_eta_sec") is not None else [])
    metric(
        "waternet_fleet_worker_relay_total", "counter",
        "Relayed answers per worker, by outcome",
        [
            ({"worker": wid, "outcome": outcome}, n)
            for wid, counts in sorted(fleet["per_worker"].items())
            for outcome, n in sorted(counts.items())
        ],
    )
    win = summary.get("window") or {}
    lat = win.get("latency_ms") or {}
    metric(
        "waternet_fleet_latency_ms", "gauge",
        "Windowed relay latency quantiles",
        [
            ({"quantile": q}, lat.get(f"p{int(float(q) * 100)}", 0.0))
            for q in ("0.5", "0.9", "0.99")
        ],
    )
    slo = summary.get("slo")
    if slo:
        states = {"ok": 0, "warn": 1, "page": 2}
        metric(
            "waternet_fleet_slo_state", "gauge",
            "Per-objective alert state (ok=0 warn=1 page=2)",
            [
                ({"objective": row["objective"]},
                 states.get(row["state"], 0))
                for row in slo.get("objectives", ())
            ],
        )
    return "\n".join(lines) + "\n"


# ----------------------------------------------------------------------
# CLI
# ----------------------------------------------------------------------


def _parse_worker_faults(specs) -> Dict[Tuple[int, int], str]:
    """``SLOT:PLAN`` or ``SLOT.GEN:PLAN`` -> {(slot, gen): plan}."""
    out: Dict[Tuple[int, int], str] = {}
    for raw in specs or ():
        head, sep, plan = raw.partition(":")
        if not sep or not plan:
            raise SystemExit(
                f"--worker-faults wants SLOT[:.GEN]:PLAN, got {raw!r}"
            )
        if "." in head:
            slot_s, gen_s = head.split(".", 1)
        else:
            slot_s, gen_s = head, "0"
        try:
            out[(int(slot_s), int(gen_s))] = plan
        except ValueError:
            raise SystemExit(
                f"--worker-faults wants integer slot/generation, got {raw!r}"
            )
    return out


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m waternet_tpu_torch.serving.fleet",
        description="Supervised multi-worker serving router. Arguments "
        "after -- are passed to every serving worker "
        "(python -m waternet_tpu_torch.serving.server).",
    )
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument(
        "--port", type=int, default=8080,
        help="Router port; 0 = ephemeral (printed on the 'listening on' "
        "line). Workers always bind ephemeral local ports.",
    )
    parser.add_argument(
        "--workers", type=int, default=2,
        help="Initial (and minimum) serving worker processes.",
    )
    parser.add_argument(
        "--max-workers", type=int, default=None,
        help="Scale-up ceiling for the SLO closed loop "
        "(default: --workers, i.e. no autoscaling).",
    )
    parser.add_argument(
        "--late-sec", type=float, default=3.0,
        help="Heartbeat age that marks a worker late (logged only).",
    )
    parser.add_argument(
        "--hang-sec", type=float, default=6.0,
        help="Heartbeat age past which a worker is presumed hung: "
        "drained, SIGKILLed past --drain-grace-sec, relaunched.",
    )
    parser.add_argument(
        "--startup-grace-sec", type=float, default=300.0,
        help="Boot window per generation (torch import, CUDA context "
        "and warmup) "
        "before missing serve-phase beats count as a hang.",
    )
    parser.add_argument(
        "--drain-grace-sec", type=float, default=10.0,
        help="SIGTERM-to-SIGKILL window when retiring a failed worker.",
    )
    parser.add_argument(
        "--grace-sec", type=float, default=30.0,
        help="Router drain window: relays in flight must finish within "
        "it for exit 0 (workers are drained after).",
    )
    parser.add_argument("--poll-sec", type=float, default=0.25)
    parser.add_argument("--health-poll-sec", type=float, default=0.5)
    parser.add_argument(
        "--route-retries", type=int, default=2,
        help="Re-dispatch budget for a relay whose worker demonstrably "
        "failed mid-answer (verdict answers like 429/503/504 relay "
        "as-is, they are never retried).",
    )
    parser.add_argument(
        "--proxy-timeout-sec", type=float, default=120.0,
        help="Per-attempt relay timeout; a worker that exceeds it is "
        "treated as failed for this request and the relay re-dispatches.",
    )
    parser.add_argument(
        "--slo", type=str, default=None, metavar="SPEC",
        help="Arm the fleet SLO closed loop over RELAYED outcomes, e.g. "
        '"p99_ms<=250,error_rate<=0.01". Sustained page burn scales the '
        "fleet up (to --max-workers) and applies the brown-out policy; "
        "sustained ok scales down and restores.",
    )
    parser.add_argument("--slo-short-sec", type=float,
                        default=obswin.DEFAULT_WINDOW_SEC)
    parser.add_argument("--slo-long-sec", type=float,
                        default=obswin.DEFAULT_LONG_WINDOW_SEC)
    parser.add_argument("--slo-hold-sec", type=float, default=60.0)
    parser.add_argument(
        "--scale-cooldown-sec", type=float, default=30.0,
        help="Minimum spacing between scale actions (anti-flap).",
    )
    parser.add_argument(
        "--no-forecast", action="store_true",
        help="Disable the queue-depth forecaster (on by default when "
        "the --slo spec has a latency objective): predictive "
        "scale-up/down composing with the burn loop.",
    )
    parser.add_argument(
        "--forecast-horizon-sec", type=float, default=30.0,
        help="Scale up when the forecast queue depth breaches the "
        "latency objective within this many seconds.",
    )
    parser.add_argument(
        "--forecast-up-sustain", type=int, default=2,
        help="Consecutive breach-forecast ticks before a predictive "
        "scale-up (hysteresis).",
    )
    parser.add_argument(
        "--forecast-down-sustain", type=int, default=6,
        help="Consecutive low-forecast ticks before a predictive "
        "scale-down (hysteresis).",
    )
    parser.add_argument(
        "--brownout-watermark", type=int, default=1,
        help="Downgrade watermark POSTed to every worker while paging: "
        "1 = every opted-in quality request downgrades under any load.",
    )
    parser.add_argument(
        "--heartbeat-dir", type=str, default=None,
        help="Root for worker heartbeat files (default: a tempdir).",
    )
    parser.add_argument(
        "--worker-faults", action="append", default=None,
        metavar="SLOT[:.GEN]:PLAN",
        help="Deterministic fault plan for exactly one worker "
        "generation, e.g. '1:gateway_crash@3' (docs/RESILIENCE.md).",
    )
    parser.add_argument("--max-restarts", type=int, default=5)
    parser.add_argument(
        "--response-cache", type=int, default=0, metavar="N",
        help="Router-level content-addressed /enhance response cache "
        "holding up to N answers (0 = off, the default). Keys include "
        "the requested tier; only full-tier answers are stored, and "
        "/admin/reload through the router invalidates everything.",
    )
    parser.add_argument(
        "worker_args", nargs=argparse.REMAINDER,
        help="Arguments after -- go to every serving worker.",
    )
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    worker_args = list(args.worker_args)
    if worker_args and worker_args[0] == "--":
        worker_args = worker_args[1:]
    worker_cmd = [
        sys.executable, "-m", "waternet_tpu_torch.serving.server",
    ] + worker_args
    router = FleetRouter(
        worker_cmd,
        n_workers=args.workers,
        max_workers=args.max_workers,
        host=args.host,
        port=args.port,
        late_sec=args.late_sec,
        hang_sec=args.hang_sec,
        startup_grace_sec=args.startup_grace_sec,
        drain_grace_sec=args.drain_grace_sec,
        poll_sec=args.poll_sec,
        health_poll_sec=args.health_poll_sec,
        route_retries=args.route_retries,
        proxy_timeout_sec=args.proxy_timeout_sec,
        grace_sec=args.grace_sec,
        slo=args.slo,
        slo_short_sec=args.slo_short_sec,
        slo_long_sec=args.slo_long_sec,
        slo_hold_sec=args.slo_hold_sec,
        scale_cooldown_sec=args.scale_cooldown_sec,
        forecast=not args.no_forecast,
        forecast_horizon_sec=args.forecast_horizon_sec,
        forecast_up_sustain=args.forecast_up_sustain,
        forecast_down_sustain=args.forecast_down_sustain,
        brownout_watermark=args.brownout_watermark,
        heartbeat_root=args.heartbeat_dir,
        worker_faults=_parse_worker_faults(args.worker_faults),
        max_restarts=args.max_restarts,
        response_cache=args.response_cache,
    )
    return router.run(install_signal_handlers=True)


if __name__ == "__main__":
    sys.exit(main())
