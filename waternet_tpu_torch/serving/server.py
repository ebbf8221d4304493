"""Serving front door: an asyncio, stdlib-only HTTP gateway over the
dynamic batcher (docs/SERVING.md "Front door").

The port of the JAX package's ``serving/server.py``:
``python -m waternet_tpu_torch.serving.server --weights w.npz`` listens on
one port and feeds decoded request images straight into the
:class:`DynamicBatcher` queue, on CUDA unless ``--device cpu``:

* **Admission control + bounded backpressure.** The batcher's request
  queue is bounded (``max_queue``); past the ``admit_watermark`` the
  server sheds with ``429 Too Many Requests`` + ``Retry-After`` instead
  of queueing forever. Every shed is counted (``shed_count``), and no
  admitted request is ever silently dropped: each one resolves to a
  response or a counted deadline expiry.
* **Per-request deadlines.** An ``X-Deadline-Ms`` header becomes an
  absolute deadline propagated into the batcher: a budget that cannot be
  met is rejected up front with ``504``; a pending request whose budget
  runs out is dropped at dispatch with a counter (not computed); and the
  deadline CLAMPS the coalescing window.
* **Graceful drain.** SIGTERM/SIGINT (latched by
  :class:`~waternet_tpu_torch.resilience.preemption.PreemptionGuard` —
  a flag, no work in the handler) stops admission (``503`` +
  ``Connection: close``), drains every in-flight batch through the
  replica pool, flushes the stats JSON, and exits 0 within ``grace_sec``.
* **Hot weight reload.** ``POST /admin/reload`` swaps the replicas'
  weights atomically between batches without dropping in-flight
  requests, validating names / shapes / dtypes through
  :func:`~waternet_tpu_torch.utils.checkpoint.params_mismatch_report`
  and rolling back (no swap) on a mismatch. Same-shaped weights meet no
  new batch shape: a reload causes no cold dispatch.
* **Readiness + observability.** ``GET /healthz`` reports ready only
  after warmup completes (and not draining), with the replica
  supervision verdict: ``ok`` / ``degraded`` (some replicas quarantined,
  still 200) / ``unhealthy`` (no available replica, 503). ``GET /stats``
  exposes the live :class:`ServingStats` schema; ``GET /metrics`` the
  same summary in Prometheus text format.
* **Fault isolation + brown-out.** The batcher's replica pools run under
  supervision (docs/SERVING.md "Fault isolation"): a crashing or hung
  replica is quarantined, its requests transparently re-dispatched
  (byte-identical results), and the replica re-warmed and reintegrated.
  The ``gateway_crash``, ``gateway_hang`` and ``reject_admit`` fault
  kinds (``WATERNET_FAULTS``) fire here. Quality requests that opt in
  via ``X-Tier-Allow-Downgrade: 1`` are served by the fast tier instead
  of shed once the quality queue passes the downgrade watermark
  (``POST /admin/policy`` moves it at run time); ``X-Tier-Served`` on
  the response names the tier that actually served.
* **Quality tiers.** ``--student-weights`` adds the fast tier, the
  distilled CAN student (``StudentEngine``) in its own replica pool on
  the same ladder; ``X-Tier: fast`` picks it per request. Without a
  student, ``X-Tier: fast`` answers 400 "fast tier not configured".
* **Response cache** (off by default). ``--response-cache N`` arms a
  bounded LRU over rendered ``/enhance`` answers keyed on (payload
  digest, tier, bucket ladder, weights generation) — hits stamp
  ``X-Cache: hit``, reloads invalidate, and downgraded answers are never
  stored.

Endpoints: ``POST /enhance`` (image file bytes in, PNG out — the body is
whatever ``cv2.imdecode`` reads, which is exactly what ``cv2.imread``
reads on the local path, so the CLI and the service stay behaviorally
interchangeable via ``python -m waternet_tpu_torch.inference
--serve-url``); ``GET /healthz``; ``GET /stats``; ``GET /metrics``;
``POST /admin/reload``; ``POST /admin/policy``. ``POST /stream`` answers 404: stream sessions
are ROADMAP Queue A item 6 (streams), with the fleet router's worker
identity and heartbeats.

The HTTP layer is hand-rolled on ``asyncio.start_server`` (persistent
connections, Content-Length bodies). Request decode runs in the loop's
default executor and response encode in a sized ``--encode-threads``
pool with per-thread reusable staging buffers, so the event loop never
blocks on cv2. ``--coalesce`` picks the batching window policy and
``--png-level`` trades response-encode CPU for bytes.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np

from waternet_tpu_torch.data.pipeline import THREAD_PREFIX
from waternet_tpu_torch.obs import trace
from waternet_tpu_torch.obs.prometheus import render_prometheus
from waternet_tpu_torch.resilience import faults
from waternet_tpu_torch.resilience.preemption import PreemptionGuard
from waternet_tpu_torch.serving.batcher import (
    DeadlineExpired,
    DynamicBatcher,
    QueueFull,
    UnknownTier,
    resolve_ladder,
)
from waternet_tpu_torch.serving.replicas import (
    AVAILABLE_STATES,
    ReplicaUnavailable,
    SupervisionConfig,
)
from waternet_tpu_torch.serving.reuse import ResponseCache
from waternet_tpu_torch.serving.stats import ServingStats

_REASONS = {
    200: "OK",
    400: "Bad Request",
    404: "Not Found",
    405: "Method Not Allowed",
    409: "Conflict",
    413: "Payload Too Large",
    429: "Too Many Requests",
    500: "Internal Server Error",
    503: "Service Unavailable",
    504: "Gateway Timeout",
}

#: Request bodies above this are refused with 413 before buffering: a
#: front door that buffers arbitrary uploads is an OOM, not a service.
MAX_BODY_BYTES = 64 << 20


class ReloadMismatch(RuntimeError):
    """Hot reload refused: the new weights do not fit the serving model
    (tree / shape / dtype diff in ``args[0]``). Nothing was swapped."""


def _request_id(headers: dict) -> str:
    """The request's correlation id: the client's ``X-Request-Id`` when
    it is a sane header token, else a fresh one. The id is echoed back
    verbatim in a response header, so anything that could smuggle CRLF
    or grow unbounded is replaced, not escaped."""
    raw = headers.get("x-request-id", "").strip()
    if (
        raw
        and len(raw) <= 128
        and all(c.isalnum() or c in "-_.:/" for c in raw)
    ):
        return raw
    return trace.new_request_id()


def _content_length(headers: dict) -> int:
    """Parsed Content-Length, 0 for absent/malformed/negative — the ONE
    parse both the reader and the router use, so a header like ``abc``
    (or ``-1``, which would make ``readexactly`` raise) degrades to an
    empty body instead of an unhandled ValueError."""
    try:
        return max(0, int(headers.get("content-length", "0")))
    except ValueError:
        return 0


def _decode_request_image(body: bytes):
    """Image file bytes -> (bgr, rgb) exactly as the local CLI decodes
    them (``cv2.imdecode`` == ``cv2.imread`` on file bytes), or None.

    None for anything undecodable, INCLUDING the empty body: imdecode
    returns None for garbage bytes but RAISES on an empty buffer, and a
    raise here would kill the connection handler instead of answering
    400."""
    import cv2

    if not body:
        return None
    try:
        bgr = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
    except cv2.error:
        return None
    if bgr is None:
        return None
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


#: What waits for a later slice: the route answers 404 with this, and the
#: server CLI's flags of these parts exit 2 naming their ROADMAP item.
LATER = {
    "streams": "ROADMAP Queue A item 6 (streams: serving/streams.py)",
}

# Reusable per-thread BGR staging canvas for the encode path (the
# copy-lean response path, docs/SERVING.md "Adaptive scheduling"):
# cvtColor writes into a thread-local dst instead of allocating a fresh
# canvas per response, so a sized encode pool settles on one buffer per
# thread per shape. threading.local IS the guard — no cross-thread
# sharing exists, so no lock (and no guarded-by) is needed.
_ENCODE_TL = threading.local()


def _encode_response_png(
    rgb: np.ndarray, png_level: Optional[int] = None
) -> bytes:
    """Enhanced RGB -> PNG bytes in file orientation (BGR), the inverse
    of :func:`_decode_request_image` — a client that imdecodes + imwrites
    the response produces byte-identical files to local serving.

    ``png_level`` (0-9) maps to ``IMWRITE_PNG_COMPRESSION``; None (the
    default) omits the parameter entirely, so the output stays
    byte-identical to every release before the knob existed."""
    import cv2

    bgr = getattr(_ENCODE_TL, "bgr", None)
    if bgr is None or bgr.shape != rgb.shape:
        bgr = np.empty_like(rgb)
        _ENCODE_TL.bgr = bgr
    cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR, dst=bgr)
    params = (
        [] if png_level is None
        else [int(cv2.IMWRITE_PNG_COMPRESSION), int(png_level)]
    )
    ok, buf = cv2.imencode(".png", bgr, params)
    if not ok:
        raise RuntimeError("PNG encode failed")
    return buf.tobytes()


class ServingServer:
    """One HTTP front door over one engine + one :class:`DynamicBatcher`.

    Lifecycle: construct (cheap — no device work), then either
    :meth:`run` (blocking; the ``main()`` path, installs the
    PreemptionGuard) or :meth:`start_background` (tests/bench: serves
    from a daemon thread; stop with :meth:`request_drain` +
    :meth:`join`). The batcher — and its warmup — is built on a
    background thread after the socket is already listening, so
    ``/healthz`` answers (not ready) during warmup and a load balancer
    can health-check a starting server.
    """

    def __init__(
        self,
        engine,
        ladder,
        host: str = "127.0.0.1",
        port: int = 0,
        max_batch: int = 8,
        max_wait_ms: float = 10.0,
        replicas=1,
        max_queue: int = 256,
        admit_watermark: Optional[int] = None,
        grace_sec: float = 30.0,
        min_deadline_ms: float = 0.0,
        stats: Optional[ServingStats] = None,
        supervision: Optional[SupervisionConfig] = None,
        slo: Optional[str] = None,
        response_cache: int = 0,
        obs_loop_lag: bool = False,
        coalesce: str = "fixed",
        png_level: Optional[int] = None,
        encode_threads: int = 2,
        fast_engine=None,
        downgrade_watermark: Optional[int] = None,
    ):
        if png_level is not None and not (0 <= int(png_level) <= 9):
            raise ValueError(
                f"png_level must be in [0, 9] (zlib levels), got {png_level}"
            )
        if encode_threads < 1:
            raise ValueError(
                f"encode_threads must be >= 1, got {encode_threads}"
            )
        if admit_watermark is None:
            # Shed before QueueFull would fire: the watermark is the soft
            # limit with headroom for requests already racing past it.
            admit_watermark = max(1, (3 * max_queue) // 4)
        if downgrade_watermark is None:
            # Brown-out trips where shedding would: an opted-in quality
            # request at the admit watermark downgrades instead of 429ing
            # (only meaningful with a fast engine configured).
            downgrade_watermark = admit_watermark
        self.engine = engine
        self.fast_engine = fast_engine
        self.downgrade_watermark = int(downgrade_watermark)
        self.ladder = ladder
        self.host = host
        self.port = int(port)
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        # Coalescing mode (docs/SERVING.md "Adaptive scheduling"):
        # "fixed" holds every partial batch for max_wait_ms (the
        # constructor default); "adaptive" treats max_wait_ms as a CAP
        # and sizes the effective window from the live arrival rate (the
        # CLI default). Validated by the batcher's CoalesceController.
        self.coalesce = str(coalesce)
        self.png_level = None if png_level is None else int(png_level)
        self.encode_threads = int(encode_threads)
        self._encode_pool = None  # built in _main, closed in its finally
        self.replicas = replicas
        self.max_queue = int(max_queue)
        self.admit_watermark = int(admit_watermark)
        self.grace_sec = float(grace_sec)
        self.min_deadline_ms = float(min_deadline_ms)
        self.supervision = supervision
        self.stats = stats if stats is not None else ServingStats()
        # Content-addressed /enhance response cache (0 entries = off).
        # Keyed on (payload digest, tier, ladder identity, weights
        # generation); only never-downgraded answers are stored, so a hit
        # is policy-correct for any requester of that tier.
        self.response_cache = (
            ResponseCache(
                response_cache, ladder_id=",".join(ladder.describe())
            )
            if response_cache
            else None
        )
        if self.response_cache is not None:
            self.stats.cache_probe = self.response_cache.counters
        # Event-loop-lag sampler (--obs-loop-lag, default off): a
        # LoopTracer with an infinite threshold — gauges only, never
        # raises — feeding the loop_lag block on /stats and /metrics.
        self.obs_loop_lag = bool(obs_loop_lag)
        self._loop_tracer = None
        self.slo_spec = slo
        if slo:
            from waternet_tpu_torch.obs.slo import SloEngine, parse_slo

            # Parse errors surface at construction (bad --slo exits the
            # CLI before any engine warms), and the armed engine grades
            # /healthz and annotates /stats + /metrics from then on.
            self.stats.arm_slo(SloEngine(parse_slo(slo), spec=slo))
        self.batcher: Optional[DynamicBatcher] = None
        self.bound_port: Optional[int] = None
        self.ready = threading.Event()
        self.draining = threading.Event()
        self._bound = threading.Event()
        self._drain_flag = False
        self._inflight = 0  # guarded-by: self._inflight_lock
        self._inflight_lock = threading.Lock()
        self._reload_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._exit_code: Optional[int] = None
        self._error: Optional[BaseException] = None

    # -- lifecycle -----------------------------------------------------

    def run(self, install_signal_handlers: bool = True) -> int:
        """Serve until drain completes; returns the process exit code
        (0 = clean drain within the grace window)."""
        return asyncio.run(self._main(install_signal_handlers))

    def start_background(self, timeout: float = 30.0) -> "ServingServer":
        """Tests/bench entry: serve from a daemon thread (no signal
        handlers — trigger shutdown with :meth:`request_drain`). Returns
        once the socket is bound (``bound_port`` is set); warmup may
        still be running — poll :meth:`wait_ready`."""

        def _target():
            try:
                self._exit_code = self.run(install_signal_handlers=False)
            except BaseException as err:  # surfaced by wait_ready/join
                self._error = err
                self._exit_code = 1
                self._bound.set()

        self._thread = threading.Thread(
            target=_target, name=f"{THREAD_PREFIX}-serve-http", daemon=True
        )
        self._thread.start()
        if not self._bound.wait(timeout):
            raise RuntimeError("server did not bind within the timeout")
        if self._error is not None:
            raise RuntimeError("server failed to start") from self._error
        return self

    def wait_ready(self, timeout: float = 120.0) -> None:
        deadline = time.monotonic() + timeout
        while not self.ready.wait(0.1):
            if self._error is not None:
                raise RuntimeError("server died during warmup") from self._error
            if time.monotonic() > deadline:
                raise RuntimeError("server warmup did not finish in time")

    def request_drain(self) -> None:
        """Thread-safe drain trigger — what SIGTERM does, callable."""
        self._drain_flag = True

    def join(self, timeout: float = 120.0) -> int:
        """Wait for a background server to finish; returns its exit code."""
        if self._thread is None:
            raise RuntimeError("server was not started in background")
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError("server did not exit within the timeout")
        return int(self._exit_code)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.bound_port}"

    async def _main(self, install_signals: bool) -> int:
        guard = PreemptionGuard() if install_signals else None
        if guard is not None:
            guard.__enter__()
        server = None
        if self.obs_loop_lag:
            from waternet_tpu_torch.analysis.looptrace import LoopTracer

            # Infinite threshold: production sampling records max/p99
            # lag for the loop_lag gauge but never raises.
            self._loop_tracer = LoopTracer(threshold_ms=float("inf"))
            self._loop_tracer.install()
            tracer = self._loop_tracer
            self.stats.loop_lag_probe = lambda: {
                "enabled": True, **tracer.gauge()
            }
        try:
            server = await asyncio.start_server(
                self._handle_connection, self.host, self.port
            )
            self.bound_port = server.sockets[0].getsockname()[1]
            self._bound.set()
            print(
                f"waternet-serve: listening on http://{self.host}:"
                f"{self.bound_port}",
                flush=True,
            )

            # Warmup in the executor: /healthz answers (503, ready:false)
            # the whole time, so orchestrators see a live-but-not-ready
            # process instead of a connection refusal.
            def _build_batcher():
                return DynamicBatcher(
                    self.engine,
                    self.ladder,
                    max_batch=self.max_batch,
                    max_wait_ms=self.max_wait_ms,
                    stats=self.stats,
                    replicas=self.replicas,
                    max_queue=self.max_queue,
                    fast_engine=self.fast_engine,
                    supervision=self.supervision,
                    downgrade_watermark=self.downgrade_watermark,
                    coalesce=self.coalesce,
                )

            # Sized encode pool (the copy-lean response path): response
            # PNG encodes get their OWN bounded pool instead of the
            # loop's shared default executor, so a burst of encodes can
            # never starve decode / reload work.
            self._encode_pool = ThreadPoolExecutor(
                max_workers=self.encode_threads,
                thread_name_prefix=f"{THREAD_PREFIX}-serve-encode",
            )
            loop = asyncio.get_running_loop()
            self.batcher = await loop.run_in_executor(None, _build_batcher)
            self.ready.set()
            print(
                f"waternet-serve: ready ({len(self.ladder)} buckets x "
                f"{self.batcher.n_replicas} replicas warmed on "
                f"{self.engine.device}, batch {self.batcher.max_batch}, "
                f"coalesce {self.batcher.coalesce_mode} cap "
                f"{self.max_wait_ms:g} ms)",
                flush=True,
            )

            # Serve until a drain is requested (signal or request_drain).
            while not (
                self._drain_flag or (guard is not None and guard.requested)
            ):
                await asyncio.sleep(0.05)

            # Drain: admission is off the moment this is set (handlers
            # answer 503 + Connection: close); everything already
            # admitted flows through the replica pool to completion.
            self.draining.set()
            print("waternet-serve: draining", flush=True)
            self.batcher.drain()  # flush partial batches immediately
            deadline = time.monotonic() + self.grace_sec
            clean = False
            while time.monotonic() < deadline:
                with self._inflight_lock:
                    inflight = self._inflight
                if inflight == 0 and self.batcher.queue_depth() == 0:
                    clean = True
                    break
                await asyncio.sleep(0.02)
            # Let the last response bytes reach their sockets before the
            # loop (and its connections) goes away.
            await asyncio.sleep(0.05)
            return 0 if clean else 1
        finally:
            if self._loop_tracer is not None:
                self._loop_tracer.uninstall()
            if self._encode_pool is not None:
                self._encode_pool.shutdown(wait=True)
            if server is not None:
                server.close()
                await server.wait_closed()
            if self.batcher is not None:
                self.batcher.close()
            if guard is not None:
                guard.__exit__(None, None, None)
            # Stats flush: the drain contract — the run's numbers survive
            # the process, in the same JSON block the CLI prints.
            print(self.stats.to_json(), flush=True)

    def _encode_png(self, rgb: np.ndarray) -> bytes:
        """The server's configured encode: :func:`_encode_response_png`
        at this server's ``--png-level`` (None = cv2's default, byte-
        identical to pre-knob releases)."""
        return _encode_response_png(rgb, self.png_level)

    def _config_block(self) -> dict:
        """The ``config`` block of /stats: the scheduling knobs an
        operator needs to interpret the gauges next to them
        (docs/SERVING.md "Adaptive scheduling")."""
        return {
            "coalesce": self.coalesce,
            "max_wait_ms": self.max_wait_ms,
            "max_batch": self.max_batch,
            "png_level": self.png_level,
            "encode_threads": self.encode_threads,
        }

    # -- HTTP plumbing -------------------------------------------------

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
            pass  # client went away; nothing to answer
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _read_request(
        self, reader
    ) -> Optional[Tuple[str, str, dict, bytes]]:
        """One HTTP/1.1 request -> (method, path, headers, body); None on
        a cleanly closed connection."""
        # readline converts LimitOverrunError to ValueError past the
        # stream's 64 KiB limit — an oversized request/header line from a
        # hostile client must close the connection, not kill the handler.
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
            return (method, target, headers, b"")  # handler answers 413
        body = await reader.readexactly(length) if length else b""
        return method, target.split("?", 1)[0], headers, body

    def _respond(
        self,
        writer,
        status: int,
        body: bytes,
        ctype: str = "application/json",
        extra=(),
        close: bool = False,
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
            writer,
            status,
            json.dumps(payload).encode(),
            extra=extra,
            close=close,
        )

    # -- routing -------------------------------------------------------

    async def _dispatch(self, req, reader, writer) -> bool:
        method, path, headers, body = req
        want_close = headers.get("connection", "").lower() == "close"
        if _content_length(headers) > MAX_BODY_BYTES:
            return self._json(
                writer, 413, {"error": "payload too large"}, close=True
            )
        if path == "/stream":
            # A stream upload has no Content-Length: the rest of the
            # connection is frames, so the answer closes it.
            return self._json(
                writer, 404,
                {"error": f"no route {path}: stream sessions are "
                 f"{LATER['streams']}"},
                close=True,
            )
        if path == "/healthz":
            return self._healthz(writer) and not want_close
        if path == "/stats":
            # The summary plus the server's config block: gauges like
            # eff_wait_ms only mean something next to the mode and cap
            # that produced them.
            payload = self.stats.summary()
            payload["config"] = self._config_block()
            return (
                self._json(writer, 200, payload)
                and not want_close
            )
        if path == "/metrics":
            # Prometheus text format, derived from the SAME summary dict
            # /stats serves — one vocabulary, two wire formats
            # (docs/OBSERVABILITY.md "/metrics").
            return (
                self._respond(
                    writer,
                    200,
                    render_prometheus(self.stats.summary()).encode(),
                    ctype="text/plain; version=0.0.4; charset=utf-8",
                )
                and not want_close
            )
        if path in ("/enhance", "/v1/enhance"):
            if method != "POST":
                return self._json(
                    writer, 405, {"error": "POST image bytes to /enhance"}
                )
            return await self._enhance(headers, body, writer) and not want_close
        if path == "/admin/reload":
            if method != "POST":
                return self._json(
                    writer, 405, {"error": "POST {\"weights\": path}"}
                )
            return await self._reload(body, writer) and not want_close
        if path == "/admin/policy":
            if method != "POST":
                return self._json(
                    writer, 405, {"error": 'POST {"downgrade_watermark": N|null}'},
                )
            return self._policy(body, writer) and not want_close
        return self._json(writer, 404, {"error": f"no route {path}"})

    def _healthz(self, writer) -> bool:
        """Readiness + replica health (docs/SERVING.md "Fault
        isolation"): ``ok`` when every replica of every tier is
        available; ``degraded`` (still 200 — the pool is serving) when
        some replicas are quarantined/re-warming but every tier keeps at
        least one available; ``unhealthy`` (503) when any tier has zero
        available replicas. Warming and draining stay 503 as before."""
        ready = self.ready.is_set() and not self.draining.is_set()
        payload = {
            "ready": ready,
            "warmed": self.ready.is_set(),
            "draining": self.draining.is_set(),
        }
        if not self.ready.is_set():
            payload["status"] = "warming"
            return self._json(writer, 503, payload)
        health = self.batcher.health()  # {tier: {index: state}}
        payload["replicas"] = {
            t: {str(i): s for i, s in sorted(m.items())}
            for t, m in sorted(health.items())
        }
        tier_available = {
            t: any(s in AVAILABLE_STATES for s in m.values())
            for t, m in health.items()
        }
        any_sick = any(
            s not in AVAILABLE_STATES for m in health.values()
            for s in m.values()
        )
        if self.draining.is_set():
            payload["status"] = "draining"
            return self._json(writer, 503, payload)
        if not all(tier_available.values()):
            payload["ready"] = False  # a tier with zero available replicas
            payload["status"] = "unhealthy"
            return self._json(writer, 503, payload)
        # An armed SLO engine grades health too: a paging objective turns
        # an otherwise-green pool "degraded" (still 200 — it is serving,
        # just out of budget; docs/OBSERVABILITY.md "Windows & SLOs").
        slo_block = self.stats.slo_state()
        slo_degraded = False
        if slo_block is not None:
            payload["slo"] = {
                "grade": slo_block["grade"],
                "state": slo_block["state"],
                "spec": slo_block["spec"],
            }
            slo_degraded = slo_block["grade"] == "degraded"
        payload["status"] = (
            "degraded" if (any_sick or slo_degraded) else "ok"
        )
        return self._json(writer, 200, payload)

    # -- /enhance ------------------------------------------------------

    async def _enhance(self, headers, body, writer) -> bool:
        # X-Request-Id correlation (docs/OBSERVABILITY.md): accept the
        # client's id or generate one, echo it on EVERY response, and
        # stamp it on every span this request touches — a failed loadgen
        # request can be found in the server trace by its id.
        req_id = _request_id(headers)
        rid = (("X-Request-Id", req_id),)

        def jresp(status, payload, extra=(), close=False):
            return self._json(
                writer, status, payload, extra=tuple(extra) + rid,
                close=close,
            )

        # Deterministic gateway faults (docs/RESILIENCE.md): the K-th
        # /enhance ARRIVAL — counted before admission, so fault ordinals
        # are arrival ordinals — can kill this whole process or wedge it.
        gate = faults.gateway_fault()
        if gate.crash:
            # SIGKILL semantics on purpose: no goodbye bytes, the
            # connection just drops mid-request — the failover the fleet
            # router must absorb.
            os.kill(os.getpid(), signal.SIGKILL)
        if gate.hang is not None:
            # Blocking the LOOP thread is the point: /healthz and every
            # open connection freeze together, which is exactly the
            # wedge a router's hang detection must catch.
            gate.hang.wait()

        t_req0 = time.perf_counter() if trace.enabled() else None
        if self.draining.is_set():
            # Drain contract: late arrivals are refused AND the
            # connection closes, so pooled clients re-resolve elsewhere.
            return jresp(503, {"error": "draining"}, close=True)
        if not self.ready.is_set():
            return jresp(
                503,
                {"error": "warming up"},
                extra=(("Retry-After", "1"),),
            )

        # Tier routing (docs/SERVING.md "Quality tiers"): X-Tier selects
        # the serving model per request; unknown names — and "fast" on a
        # server started without --student-weights — are 400, loudly:
        # a tier is a quality contract, not a routing hint.
        tier = headers.get("x-tier", "quality").strip().lower()
        if tier not in ("quality", "fast"):
            return jresp(400, {"error": f"unknown tier {tier!r}", "tiers": list(self.batcher.tiers)})
        if tier not in self.batcher.tiers:
            return jresp(400, {
                "error": "fast tier not configured on this server "
                "(start the server with --student-weights)",
                "tiers": list(self.batcher.tiers),
            })
        # Brown-out opt-in: an X-Tier-Allow-Downgrade'd quality request
        # under saturation is served by the fast tier instead of shed;
        # X-Tier-Served names the tier that actually served. Never
        # applied without the opt-in.
        allow_downgrade = headers.get("x-tier-allow-downgrade", "").strip().lower() in ("1", "true", "yes")
        downgrade_eligible = allow_downgrade and tier == "quality" and "fast" in self.batcher.tiers

        # Deadline parse + up-front feasibility: a budget the server
        # already knows it cannot meet is refused before it queues.
        deadline = None
        raw = headers.get("x-deadline-ms")
        if raw is not None:
            try:
                budget_ms = float(raw)
            except ValueError:
                return jresp(400, {"error": f"bad X-Deadline-Ms {raw!r}"})
            if budget_ms <= 0 or budget_ms < self.min_deadline_ms:
                self.stats.record_deadline_expired()
                return jresp(
                    504,
                    {
                        "error": "deadline cannot be met",
                        "budget_ms": budget_ms,
                        "min_deadline_ms": self.min_deadline_ms,
                    },
                )
            deadline = time.perf_counter() + budget_ms / 1e3

        # Content-addressed response cache (docs/SERVING.md "Temporal
        # reuse & response cache"; off unless --response-cache): a
        # digest hit replays the stored PNG without admission, decode,
        # or compute.
        cache_key = None
        if self.response_cache is not None:
            cache_key = self.response_cache.key(body, tier)
            cached = self.response_cache.get(cache_key)
            if cached is not None:
                keep = self._respond(
                    writer, 200, cached, ctype="image/png",
                    extra=(
                        ("X-Tier-Served", tier), ("X-Cache", "hit"),
                    ) + rid,
                )
                await writer.drain()
                if t_req0 is not None:
                    trace.record_span(
                        "response_cache", "serving", t_req0,
                        time.perf_counter(),
                        args={"request_id": req_id, "tier": tier,
                              "result": "hit", "bytes": len(cached)},
                    )
                return keep

        # Admission control: the deterministic fault hook, then the
        # queue-depth watermark — both shed with 429 + Retry-After.
        if faults.admit_should_reject():
            self.stats.record_shed()
            return jresp(
                429,
                {"error": "admission rejected (fault injection)"},
                extra=(("Retry-After", "1"),),
            )
        depth = self.batcher.queue_depth()
        if depth >= self.admit_watermark:
            # Brown-out exemption ONLY when the downgrade will actually
            # fire (the batcher's gauge is the QUALITY-tier backlog):
            # under a fast-tier flood the quality backlog is small, no
            # downgrade would happen, and admitting past the watermark
            # would just queue to QueueFull — shed instead.
            will_downgrade = (
                downgrade_eligible
                and self.batcher.downgrade_watermark is not None
                and self.batcher.tier_depth("quality") >= self.batcher.downgrade_watermark
            )
            if not will_downgrade:
                self.stats.record_shed()
                return jresp(
                    429,
                    {"error": "overloaded", "queue_depth": depth},
                    extra=(("Retry-After", "1"),),
                )

        loop = asyncio.get_running_loop()
        # In-flight from BEFORE the decode: the drain poll must not see
        # zero while an admitted request is still in the executor — the
        # batcher would close under it and drop an accepted request.
        with self._inflight_lock:
            self._inflight += 1
        try:
            rgb = await loop.run_in_executor(
                None, _decode_request_image, body
            )
            if t_req0 is not None:
                trace.record_span(
                    "decode", "serving", t_req0, time.perf_counter(),
                    args={"request_id": req_id, "tier": tier,
                          "bytes": len(body)},
                )
            if rgb is None:
                return jresp(
                    400, {"error": "body is not a decodable image"}
                )
            try:
                fut = self.batcher.submit(
                    rgb, deadline=deadline, tier=tier,
                    allow_downgrade=allow_downgrade, request_id=req_id,
                )
            except UnknownTier as err:
                return jresp(400, {"error": str(err)})
            except QueueFull as err:
                return jresp(
                    429,
                    {"error": str(err)},
                    extra=(("Retry-After", "1"),),
                )
            except DeadlineExpired as err:
                return jresp(504, {"error": str(err)})
            except RuntimeError:
                # Batcher closed between the draining check and submit
                # (drain finished while we decoded): a late arrival.
                return jresp(503, {"error": "draining"}, close=True)
            try:
                out = await asyncio.wrap_future(fut)
            except DeadlineExpired as err:
                return jresp(504, {"error": str(err)})
            except ReplicaUnavailable as err:
                # Every replica quarantined (healthz has been reporting
                # unhealthy): tell clients to come back, not that the
                # request was malformed.
                return jresp(
                    503,
                    {"error": str(err)},
                    extra=(("Retry-After", "1"),),
                )
            except Exception as err:
                return jresp(
                    500, {"error": f"{type(err).__name__}: {err}"}
                )
            t_enc0 = time.perf_counter() if trace.enabled() else None
            png = await loop.run_in_executor(
                self._encode_pool, self._encode_png, out
            )
            served = getattr(fut, "tier", tier)
            cache_extra = ()
            if cache_key is not None:
                # Brown-out policy: a downgraded answer (served != the
                # requested tier) must never be stored — a later
                # non-opt-in request with the same bytes would hit it.
                if served == tier:
                    self.response_cache.put(cache_key, png)
                cache_extra = (("X-Cache", "miss"),)
            keep = self._respond(
                writer, 200, png, ctype="image/png",
                extra=(("X-Tier-Served", served),) + cache_extra + rid,
            )
            # Flush before the in-flight decrement: the drain poll must
            # not declare the server empty while this response is still
            # in the transport's user-space buffer — asyncio.run would
            # cancel the handler and truncate it on a slow client.
            await writer.drain()
            if t_enc0 is not None:
                trace.record_span(
                    "response_write", "serving", t_enc0,
                    time.perf_counter(),
                    args={"request_id": req_id, "tier": served,
                          "bytes": len(png)},
                )
            return keep
        finally:
            with self._inflight_lock:
                self._inflight -= 1

    # -- /admin/reload -------------------------------------------------

    def _do_reload(self, path: str):
        """Load + validate + swap (worker thread). Any raise = rollback:
        nothing is swapped until validation passes."""
        from waternet_tpu_torch.hub import resolve_weights
        from waternet_tpu_torch.utils.checkpoint import params_mismatch_report

        new = resolve_weights(path)
        if new is None:
            raise FileNotFoundError(f"no weights at {path!r}")
        report = params_mismatch_report(
            new, self.engine.params, check_dtype=True
        )
        if report:
            raise ReloadMismatch(
                f"new weights do not fit the serving model — rolling back "
                f"(in-flight and future requests keep the current "
                f"weights):\n{report}"
            )
        self.batcher.set_params(new)
        if self.response_cache is not None:
            # Invalidate AFTER the swap: answers computed under the old
            # weights must never serve again, and a put racing the swap
            # carries the old generation in its key and is refused.
            self.response_cache.invalidate()

    async def _reload(self, body, writer) -> bool:
        if not self.ready.is_set() or self.draining.is_set():
            return self._json(
                writer, 503, {"error": "not ready for reload"}
            )
        try:
            payload = json.loads(body or b"{}")
            path = payload["weights"]  # TypeError when payload isn't a dict
        except (ValueError, KeyError, TypeError):
            return self._json(
                writer,
                400,
                {"error": 'body must be JSON {"weights": "<path>"}'},
            )
        loop = asyncio.get_running_loop()

        def _locked_reload():
            # Lock taken INSIDE the worker thread: acquiring it on the
            # event loop would block the loop on a concurrent reload.
            with self._reload_lock:
                self._do_reload(path)

        try:
            await loop.run_in_executor(None, _locked_reload)
        except ReloadMismatch as err:
            return self._json(
                writer, 409, {"error": str(err), "reloaded": False}
            )
        except Exception as err:
            return self._json(
                writer,
                400,
                {
                    "error": f"{type(err).__name__}: {err}",
                    "reloaded": False,
                },
            )
        print(f"waternet-serve: reloaded weights from {path}", flush=True)
        return self._json(writer, 200, {"reloaded": True, "weights": path})

    # -- /admin/policy -------------------------------------------------

    def _policy(self, body, writer) -> bool:
        """Runtime brown-out control: a fleet router POSTs a lowered
        ``downgrade_watermark`` on sustained SLO burn so opted-in quality
        traffic downgrades earlier, and restores it later. The watermark
        is a plain attribute the batcher reads at submit, so the shift
        applies to the next request — no restart, no reconfigure."""
        if not self.ready.is_set():
            return self._json(writer, 503, {"error": "not ready"})
        try:
            payload = json.loads(body or b"{}")
            if not isinstance(payload, dict):
                raise ValueError
        except ValueError:
            return self._json(writer, 400, {"error": 'body must be JSON {"downgrade_watermark": N|null}'})
        if "downgrade_watermark" in payload:
            value = payload["downgrade_watermark"]
            bad = value is not None and (isinstance(value, bool) or not isinstance(value, int) or value < 1)
            if bad:
                return self._json(
                    writer, 400,
                    {"error": f"downgrade_watermark must be a positive int or null, got {value!r}"},
                )
            self.batcher.downgrade_watermark = value
        return self._json(writer, 200, {"policy": {
            "downgrade_watermark": self.batcher.downgrade_watermark,
            "admit_watermark": self.admit_watermark,
        }})


# ----------------------------------------------------------------------
# CLI
# ----------------------------------------------------------------------

#: Server flags of the JAX CLI whose parts wait for a later slice: setting
#: one exits 2 naming its ROADMAP item.
_LATER_FLAGS = {
    "max_streams": "streams", "stream_window": "streams",
    "stream_reuse_threshold": "streams", "stream_max_reuse_run": "streams",
}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m waternet_tpu_torch.serving.server", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument(
        "--port", type=int, default=8080,
        help="0 = ephemeral (the chosen port is printed on the "
        "'listening on' line)",
    )
    parser.add_argument(
        "--weights", type=str, default=None,
        help="Model weights (.npz, JAX format, or the reference's .pt); "
        "defaults to local weight resolution.",
    )
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'.")
    parser.add_argument(
        "--serve-buckets", type=str, default="auto",
        help="Bucket ladder: 'auto' (the default square ladder — a server "
        "has no directory to scan) or an explicit comma list like "
        "'256,512,1080x1920'.",
    )
    parser.add_argument(
        "--max-batch", type=int, default=8,
        help="Warmed batch-slot count per bucket.",
    )
    parser.add_argument(
        "--max-wait-ms", type=float, default=10.0,
        help="Coalescing CAP, not a constant hold: the longest a partial "
        "batch may wait for batchmates. Under --coalesce adaptive (the "
        "default) the EFFECTIVE window moves inside [0, cap] with the "
        "live arrival rate; --coalesce fixed holds every partial batch "
        "for exactly the cap. Per-request deadlines clamp the effective "
        "window either way.",
    )
    parser.add_argument(
        "--coalesce", type=str, default="adaptive",
        choices=["adaptive", "fixed"],
        help="Coalescing-window policy (docs/SERVING.md 'Adaptive "
        "scheduling'). Responses are byte-identical across modes.",
    )
    parser.add_argument(
        "--png-level", type=int, default=None, metavar="0-9",
        help="PNG compression level for /enhance responses "
        "(IMWRITE_PNG_COMPRESSION; lower = faster encode, larger bytes). "
        "Unset keeps cv2's default.",
    )
    parser.add_argument(
        "--encode-threads", type=int, default=2,
        help="Response-encode pool size: PNG encodes run on their own "
        "bounded pool, so encode bursts cannot starve decode or control "
        "work.",
    )
    parser.add_argument(
        "--serve-replicas", type=str, default="auto",
        help="Replica-pool size: 'auto' (every CUDA card; 1 on the CPU) "
        "or N.",
    )
    parser.add_argument(
        "--max-queue", type=int, default=256,
        help="Hard bound on OUTSTANDING requests — queued, coalescing, "
        "or in flight on a replica (QueueFull past it).",
    )
    parser.add_argument(
        "--admit-watermark", type=int, default=None,
        help="Queue depth past which admission sheds with 429 + "
        "Retry-After (default: 3/4 of --max-queue).",
    )
    parser.add_argument(
        "--grace-sec", type=float, default=30.0,
        help="Drain window after SIGTERM: in-flight work must finish "
        "within it for exit 0.",
    )
    parser.add_argument(
        "--min-deadline-ms", type=float, default=0.0,
        help="Reject X-Deadline-Ms budgets below this up front with 504 "
        "(0 disables).",
    )
    parser.add_argument(
        "--device-preprocess", action="store_true", default=False,
        help="Run WB/GC/CLAHE on the device (ops/masked.py).",
    )
    parser.add_argument(
        "--watchdog-sec", type=float, default=30.0,
        help="Per-batch watchdog: a replica whose batch stays in flight "
        "past this is declared hung, quarantined, and its requests "
        "re-dispatched (docs/SERVING.md 'Fault isolation'). 0 disables "
        "the watchdog (crash isolation remains).",
    )
    parser.add_argument(
        "--serve-max-retries", type=int, default=2,
        help="Per-request re-dispatch budget after demonstrable batch "
        "failures (crash / hang / bad output).",
    )
    parser.add_argument(
        "--response-cache", type=int, default=0, metavar="N",
        help="Content-addressed /enhance response cache of up to N "
        "rendered answers, invalidated on /admin/reload. 0 (the default) "
        "disables it.",
    )
    parser.add_argument(
        "--obs-loop-lag", action="store_true",
        help="Sample event-loop callback wall time and expose max/p99 "
        "loop lag as the loop_lag block on /stats and "
        "waternet_loop_lag_* gauges on /metrics.",
    )
    parser.add_argument(
        "--slo", type=str, default=None, metavar="SPEC",
        help="Arm the SLO engine with a comma-separated objective list, "
        'e.g. "p99_ms<=250,error_rate<=0.01,availability>=0.999".',
    )
    parser.add_argument(
        "--precision", type=str, default="fp32", choices=["fp32", "bf16"],
    )
    parser.add_argument(
        "--student-weights", type=str, default=None,
        help="CAN student checkpoint (a train --distill product): enables "
        "the fast tier — requests with 'X-Tier: fast' are served by the "
        "student (raw RGB in, no WB/GC/CLAHE anywhere) from its own warmed "
        "replica pool. Without it, fast-tier requests are refused with 400.",
    )
    parser.add_argument(
        "--student-quantize", action="store_true", default=False,
        help="Serve the fast tier as static int8 (models/quant.py "
        "quantize_can). Requires --student-weights.",
    )
    parser.add_argument(
        "--downgrade-watermark", type=int, default=None,
        help="Quality-tier queue depth past which a quality request that "
        "opted in (X-Tier-Allow-Downgrade: 1) is served by the fast tier "
        "instead of shed (default: --admit-watermark). Needs "
        "--student-weights; never applied to requests that did not opt in.",
    )
    later = parser.add_argument_group(
        "parts of a later slice (setting one exits 2 naming its ROADMAP item)"
    )
    later.add_argument("--max-streams", type=int, default=None)
    later.add_argument("--stream-window", type=int, default=None)
    later.add_argument("--stream-reuse-threshold", type=float, default=None)
    later.add_argument("--stream-max-reuse-run", type=int, default=None)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    for name, part in _LATER_FLAGS.items():
        if getattr(args, name) is not None:
            flag = "--" + name.replace("_", "-")
            print(
                f"{flag} is not ported to waternet_tpu_torch yet: {LATER[part]}",
                file=sys.stderr,
            )
            return 2
    if args.student_quantize and not args.student_weights:
        # Pure flag validation — fail before any engine is built.
        print("--student-quantize needs --student-weights (there is no student to quantize)", file=sys.stderr)
        return 2
    if args.downgrade_watermark is not None and not args.student_weights:
        print(
            "--downgrade-watermark needs --student-weights: brown-out downgrades route saturated "
            "quality traffic to the fast tier, and without a student there is no fast tier",
            file=sys.stderr,
        )
        return 2
    faults.install_from_env()  # WATERNET_FAULTS serving-side fault kinds

    import torch

    from waternet_tpu_torch.inference_engine import InferenceEngine, StudentEngine

    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    engine = InferenceEngine(
        weights=args.weights,
        device_preprocess=args.device_preprocess,
        device=args.device,
        dtype=dtype,
    )
    fast_engine = None
    if args.student_weights:
        fast_engine = StudentEngine(
            weights=args.student_weights, dtype=dtype,
            quantize=args.student_quantize, device=args.device,
        )
    ladder = resolve_ladder(args.serve_buckets)
    server = ServingServer(
        engine,
        ladder,
        fast_engine=fast_engine,
        downgrade_watermark=args.downgrade_watermark,
        host=args.host,
        port=args.port,
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        replicas=args.serve_replicas,
        max_queue=args.max_queue,
        admit_watermark=args.admit_watermark,
        grace_sec=args.grace_sec,
        min_deadline_ms=args.min_deadline_ms,
        supervision=SupervisionConfig(
            watchdog_sec=(
                None if args.watchdog_sec <= 0 else args.watchdog_sec
            ),
            max_retries=args.serve_max_retries,
        ),
        slo=args.slo,
        response_cache=args.response_cache,
        obs_loop_lag=args.obs_loop_lag,
        coalesce=args.coalesce,
        png_level=args.png_level,
        encode_threads=args.encode_threads,
    )
    return server.run(install_signal_handlers=True)


if __name__ == "__main__":
    sys.exit(main())
