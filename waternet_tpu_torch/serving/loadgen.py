"""Closed-loop load generator for the HTTP front door (serving/server.py).

The JAX package's ``serving/loadgen.py``, lifted (it imports nothing of
JAX): ``python -m waternet_tpu_torch.serving.loadgen``.

Closed-loop means each of ``concurrency`` workers keeps exactly one
request outstanding on its own persistent connection — offered load
tracks the server's actual capacity times the concurrency, which is the
honest way to find a saturation point (an open-loop generator measures
its own timer, not the server). Doubling ``concurrency`` past saturation
is therefore "2x sustainable offered load": the regime where admission
control must shed rather than queue (the bench.py ``serve_http`` config
runs exactly that A/B).

Accounting is total: every request ends in exactly one of ``ok`` /
``shed`` (429) / ``deadline_expired`` (504) / ``rejected`` (other 4xx/
5xx, e.g. 503 while draining) / ``conn_reset`` (the peer closed the
connection mid-exchange — the signature of a graceful drain racing a
pooled client, NOT a crash) / ``errors`` (hard transport failures:
refused, timed out, unroutable), so the overload acceptance criterion —
no silent drops — is checkable from the report alone, and a drain test
can tell a graceful close from a dead server. ``downgraded`` counts the
subset of ``ok`` responses served by a different tier than requested
(the server's ``X-Tier-Served`` header under brown-out,
docs/SERVING.md "Fault isolation") — drive opt-in traffic with
``allow_downgrade=True`` / ``--allow-downgrade``. Stdlib-only
(http.client + threads); worker threads carry the pipeline
``THREAD_PREFIX`` so the test suite's leak guard covers them.

``--arrival-rate R`` switches request mode to **open-loop Poisson**
arrivals: request ``i`` is launched at a pre-drawn schedule time
(seeded exponential inter-arrival gaps at R req/s) regardless of what
came back — the regime where adaptive coalescing earns its keep,
because a closed-loop generator's arrival rate collapses to the
server's service rate and never exercises a queue-empty wait.
``--rate-ramp "0:20,10:200,20:20"`` drives a piecewise-constant rate
profile (seconds:rate pairs) for surge/decay drills; ``concurrency``
then bounds only the in-flight parallelism, not the offered rate.

``--stream`` switches to :func:`run_stream_load`: N paced concurrent
``POST /stream`` sessions (open-loop — live cameras do not slow down for
a busy server) with per-frame latency / drop / downgrade accounting and
the same conn_reset-vs-errors split.

Both modes add a ``window`` block — throughput and p50/p99 over only
the trailing ``--window-sec`` (default 10 s) of completions, the figure
that survives a run long enough to degrade (a lifetime average lets the
fast first minute pay for the saturated last one). ``--ledger PATH``
(request mode) additionally records every request as
``{"t", "latency_ms", "outcome"}`` for offline SLO replay:
``waternet-trace slo PATH --slo "p99_ms<=250,..."``.
"""

from __future__ import annotations

import argparse
import itertools
import json
import random
import struct
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple
from urllib.parse import urlparse

from waternet_tpu_torch.data.pipeline import THREAD_PREFIX
from waternet_tpu_torch.obs.trace import new_request_id
from waternet_tpu_torch.serving.stats import _percentile

#: Cap on the per-request failure ledger in a report: enough to chase
#: every id in a test run, bounded so a saturation run's report stays a
#: report (the full counts are always exact; only the ledger truncates,
#: and ``failures_truncated`` says by how much).
MAX_FAILURE_RECORDS = 128

#: Default trailing span for the report's ``window`` block.
DEFAULT_WINDOW_SEC = 10.0


def _window_block(
    samples: List, window_sec: float, now: Optional[float] = None
) -> Dict:
    """Trailing-``window_sec`` throughput/latency from completion
    ``(t, latency_sec)`` samples (``t`` relative to run start).

    Lifetime averages hide the end state of a run that degrades —
    the first fast minute pays for the last saturated one. This block
    reports only completions with ``t`` in ``(now - window_sec, now]``;
    the rate divisor is ``min(window_sec, now)`` so a run shorter than
    the window is not under-reported. Pure so tests can pin it without
    a server.
    """
    if now is None:
        now = max((t for t, _ in samples), default=0.0)
    recent = sorted(lat for t, lat in samples if t > now - window_sec)
    span = max(min(window_sec, now), 1e-9)
    return {
        "window_sec": float(window_sec),
        "count": len(recent),
        "requests_per_sec": round(len(recent) / span, 2),
        "latency_ms": {
            "p50": round(_percentile(recent, 0.50) * 1e3, 3),
            "p99": round(_percentile(recent, 0.99) * 1e3, 3),
        },
    }


def parse_rate_ramp(spec: str) -> List[Tuple[float, float]]:
    """``"0:20,10:200,20:20"`` -> ``[(0.0, 20.0), (10.0, 200.0),
    (20.0, 20.0)]``: piecewise-constant offered rate, each pair giving
    the req/s that holds from that second onward. Segments must start
    at 0 and be strictly increasing in time; every rate must be > 0."""
    segments: List[Tuple[float, float]] = []
    for raw in spec.split(","):
        clause = raw.strip()
        if not clause:
            continue
        t_s, sep, r_s = clause.partition(":")
        if not sep:
            raise ValueError(
                f"rate ramp wants SEC:RATE pairs, got {clause!r}"
            )
        t, r = float(t_s), float(r_s)
        if r <= 0:
            raise ValueError(f"ramp rate must be > 0, got {clause!r}")
        if segments and t <= segments[-1][0]:
            raise ValueError(
                f"ramp times must be strictly increasing at {clause!r}"
            )
        segments.append((t, r))
    if not segments or segments[0][0] != 0.0:
        raise ValueError(f"rate ramp must start at second 0: {spec!r}")
    return segments


def arrival_schedule(
    total: int,
    arrival_rate: Optional[float] = None,
    rate_ramp: Optional[List[Tuple[float, float]]] = None,
    seed: int = 0,
) -> List[float]:
    """Pre-drawn open-loop Poisson send times (seconds from run start).

    Exponential inter-arrival gaps from a seeded PRNG, so the same
    (total, rate, seed) always offers the same trace — a bench A/B run
    (fixed vs adaptive coalescing) sees literally identical arrivals.
    With ``rate_ramp``, the gap after time ``t`` is drawn at the
    segment rate active at ``t`` (piecewise-constant intensity).
    """
    if (arrival_rate is None) == (rate_ramp is None):
        raise ValueError("need exactly one of arrival_rate / rate_ramp")
    if arrival_rate is not None:
        if arrival_rate <= 0:
            raise ValueError(f"arrival_rate must be > 0, got {arrival_rate}")
        rate_ramp = [(0.0, float(arrival_rate))]
    rng = random.Random(seed)
    times: List[float] = []
    t = 0.0
    for _ in range(int(total)):
        rate = rate_ramp[0][1]
        for t_seg, r_seg in rate_ramp:
            if t >= t_seg:
                rate = r_seg
        t += rng.expovariate(rate)
        times.append(t)
    return times


def run_load(
    url: str,
    payloads: List[bytes],
    concurrency: int = 4,
    total: int = 64,
    deadline_ms: Optional[float] = None,
    path: str = "/enhance",
    timeout: float = 120.0,
    keep_bodies: bool = False,
    tier: Optional[str] = None,
    allow_downgrade: bool = False,
    window_sec: float = DEFAULT_WINDOW_SEC,
    collect_ledger: bool = False,
    per_worker: bool = False,
    arrival_rate: Optional[float] = None,
    rate_ramp: Optional[List[Tuple[float, float]]] = None,
    arrival_seed: int = 0,
) -> Dict:
    """Drive ``total`` POSTs at ``path`` with ``concurrency`` closed-loop
    workers cycling through ``payloads``; returns the accounting report.

    ``arrival_rate`` (req/s) or ``rate_ramp`` (see
    :func:`parse_rate_ramp`) switches to open-loop Poisson arrivals:
    request ``i`` launches at a pre-drawn schedule time (seeded by
    ``arrival_seed``, see :func:`arrival_schedule`) independent of
    responses, and ``concurrency`` bounds only the in-flight
    parallelism. The report then carries an ``offered`` block with the
    schedule's realized span and any launch lag (a worker pool too
    small to keep up shows up as lag, not as a silently slower rate).

    ``keep_bodies=True`` additionally returns ``bodies`` — a list of
    ``(request_index, status, body_bytes)`` — so byte-identity tests can
    check every response against the offline path. ``tier`` is forwarded
    as ``X-Tier``; ``allow_downgrade=True`` sets
    ``X-Tier-Allow-Downgrade: 1`` (the brown-out opt-in) and the report's
    ``downgraded`` counts 200s whose ``X-Tier-Served`` differs from the
    requested tier. ``cache_hits`` counts 200s stamped ``X-Cache: hit``
    — answers replayed from a content-addressed response cache
    (docs/SERVING.md "Temporal reuse & response cache"); always 0
    against a cache-less server.

    Every request carries a unique ``X-Request-Id`` (``lg-<run>-<i>``),
    which the server echoes and stamps on its trace spans
    (docs/OBSERVABILITY.md): the report's ``failures`` ledger lists each
    non-ok request's id and outcome, so a shed/reset/error in a load run
    is findable in the server-side trace by the same id.

    The report's ``window`` block restates throughput and p50/p99 over
    only the trailing ``window_sec`` of completions (see
    :func:`_window_block`) — the figure to read on a run long enough to
    degrade. ``collect_ledger=True`` additionally returns ``ledger``:
    one ``{"t", "latency_ms", "outcome", "worker"}`` entry per request
    (``t`` seconds from run start), the input format of
    ``waternet-trace slo`` offline replay (docs/OBSERVABILITY.md).

    ``per_worker=True`` adds a ``per_worker`` block splitting the same
    total accounting by the ``X-Worker-Id`` the answering serving
    worker stamped (docs/SERVING.md "Fleet") — the client half of the
    fleet bench's ledger-vs-router reconciliation. Answers without the
    header (single-worker servers, router-originated errors) and
    transport failures (nobody answered) land under ``"unattributed"``.
    """
    u = urlparse(url)
    host, port = u.hostname, u.port or 80
    run_tag = new_request_id()[:8]
    sched: Optional[List[float]] = None
    if arrival_rate is not None or rate_ramp is not None:
        sched = arrival_schedule(
            total, arrival_rate=arrival_rate, rate_ramp=rate_ramp,
            seed=arrival_seed,
        )
    lock = threading.Lock()
    counts = {
        "ok": 0, "shed": 0, "deadline_expired": 0, "rejected": 0,
        "conn_reset": 0, "errors": 0, "downgraded": 0, "cache_hits": 0,
    }
    launch_lag = [0.0]  # worst (actual - scheduled) launch time, open-loop
    latencies: List[float] = []
    samples: List = []  # (t_done - t0, latency_sec) for ok requests
    ledger_entries: List[Dict] = []
    bodies: List = []
    failures: List[Dict] = []
    per_worker_counts: Dict[str, Dict[str, int]] = {}
    truncated = [0]
    indices = itertools.count()

    def record_failure(rec: Dict) -> None:
        # Caller holds `lock`.
        if len(failures) < MAX_FAILURE_RECORDS:
            failures.append(rec)
        else:
            truncated[0] += 1

    def record_ledger(rel_t: float, outcome: str,
                      latency_s: Optional[float],
                      worker: Optional[str] = None) -> None:
        # Caller holds `lock`.
        if collect_ledger:
            ledger_entries.append({
                "t": round(rel_t, 6),
                "latency_ms": (
                    None if latency_s is None else round(latency_s * 1e3, 3)
                ),
                "outcome": outcome,
                "worker": worker,
            })

    def record_worker(worker: Optional[str], outcome: str) -> None:
        # Caller holds `lock`. Split the same total accounting by the
        # serving worker that stamped X-Worker-Id on the answer.
        if not per_worker:
            return
        bucket = per_worker_counts.setdefault(
            worker or "unattributed",
            {"ok": 0, "shed": 0, "deadline_expired": 0, "rejected": 0,
             "conn_reset": 0, "errors": 0, "downgraded": 0},
        )
        bucket[outcome] += 1

    def worker():
        import http.client

        conn = http.client.HTTPConnection(host, port, timeout=timeout)
        try:
            while True:
                with lock:
                    i = next(indices)
                if i >= total:
                    break
                if sched is not None:
                    # Open-loop: fire at the pre-drawn Poisson time, not
                    # when the last answer lands. A starved worker pool
                    # fires late; the worst lag is reported, never hidden.
                    lag = t_run0 + sched[i] - time.perf_counter()
                    if lag > 0:
                        time.sleep(lag)
                    else:
                        with lock:
                            launch_lag[0] = max(launch_lag[0], -lag)
                payload = payloads[i % len(payloads)]
                rid = f"lg-{run_tag}-{i:05d}"
                headers = {
                    "Content-Type": "application/octet-stream",
                    "X-Request-Id": rid,
                }
                if deadline_ms is not None:
                    headers["X-Deadline-Ms"] = str(deadline_ms)
                if tier is not None:
                    headers["X-Tier"] = tier
                if allow_downgrade:
                    headers["X-Tier-Allow-Downgrade"] = "1"
                t0 = time.perf_counter()
                try:
                    conn.request("POST", path, body=payload, headers=headers)
                    resp = conn.getresponse()
                    body = resp.read()
                    status = resp.status
                    served = resp.getheader("X-Tier-Served", "")
                    wid = resp.getheader("X-Worker-Id", "") or None
                    cache_hit = resp.getheader("X-Cache", "") == "hit"
                    closed = (
                        resp.getheader("Connection", "").lower() == "close"
                    )
                except Exception as err:
                    # A peer closing mid-exchange (ConnectionResetError,
                    # incl. http.client.RemoteDisconnected, BrokenPipeError)
                    # is what a graceful drain looks like to a pooled
                    # client — counted apart from hard transport errors
                    # (refused, timed out): a drain is not a crash.
                    key = (
                        "conn_reset"
                        if isinstance(
                            err, (ConnectionResetError, BrokenPipeError)
                        )
                        else "errors"
                    )
                    with lock:
                        counts[key] += 1
                        record_worker(None, key)
                        record_failure({
                            "request_id": rid,
                            "outcome": key,
                            "error": type(err).__name__,
                        })
                        record_ledger(
                            time.perf_counter() - t_run0, key, None
                        )
                    conn.close()
                    conn = http.client.HTTPConnection(
                        host, port, timeout=timeout
                    )
                    continue
                t1 = time.perf_counter()
                dt = t1 - t0
                with lock:
                    if status == 200:
                        counts["ok"] += 1
                        if cache_hit:
                            # Content-addressed response cache answered
                            # (X-Cache: hit) — still an ok, also tallied
                            # so closed-loop runs can report hit rate.
                            counts["cache_hits"] += 1
                        record_worker(wid, "ok")
                        latencies.append(dt)
                        samples.append((t1 - t_run0, dt))
                        record_ledger(t1 - t_run0, "ok", dt, worker=wid)
                        # Only meaningful when a tier was REQUESTED: a
                        # fast-default server answering tier-less traffic
                        # with X-Tier-Served: fast is not a downgrade.
                        if tier is not None and served and served != tier:
                            counts["downgraded"] += 1
                            record_worker(wid, "downgraded")
                    else:
                        if status == 429:
                            outcome = "shed"
                        elif status == 504:
                            outcome = "deadline_expired"
                        else:
                            outcome = "rejected"
                        counts[outcome] += 1
                        record_worker(wid, outcome)
                        record_failure({
                            "request_id": rid,
                            "outcome": outcome,
                            "status": status,
                        })
                        record_ledger(t1 - t_run0, outcome, None, worker=wid)
                    if keep_bodies:
                        bodies.append((i, status, body))
                if closed:
                    conn.close()
                    conn = http.client.HTTPConnection(
                        host, port, timeout=timeout
                    )
        finally:
            conn.close()

    threads = [
        threading.Thread(
            target=worker, name=f"{THREAD_PREFIX}-loadgen-{i}", daemon=True
        )
        for i in range(max(1, int(concurrency)))
    ]
    t_run0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = time.perf_counter() - t_run0

    lat_sorted = sorted(latencies)
    report = {
        "sent": total,
        **counts,
        "images_per_sec": round(counts["ok"] / elapsed, 2) if elapsed else 0.0,
        "elapsed_sec": round(elapsed, 3),
        "concurrency": int(concurrency),
        "latency_ms": {
            "p50": round(_percentile(lat_sorted, 0.50) * 1e3, 3),
            "p99": round(_percentile(lat_sorted, 0.99) * 1e3, 3),
        },
        "window": _window_block(samples, window_sec, now=elapsed),
        "request_id_prefix": f"lg-{run_tag}",
        "failures": failures,
    }
    if sched is not None:
        report["offered"] = {
            "mode": "poisson",
            "rate": arrival_rate,
            "ramp": rate_ramp,
            "span_sec": round(sched[-1], 3) if sched else 0.0,
            "max_launch_lag_ms": round(launch_lag[0] * 1e3, 3),
        }
    if truncated[0]:
        report["failures_truncated"] = truncated[0]
    if keep_bodies:
        report["bodies"] = bodies
    if collect_ledger:
        report["ledger"] = sorted(ledger_entries, key=lambda e: e["t"])
    if per_worker:
        report["per_worker"] = per_worker_counts
    return report


# ----------------------------------------------------------------------
# Stream mode: N paced concurrent POST /stream sessions
# ----------------------------------------------------------------------

# Client-side copies of the stream wire framing
# (waternet_tpu/serving/streams.py — kept import-free here so the load
# generator stays stdlib-only; the protocol-compat tests drive this
# client against a live server, so drift cannot go unnoticed).
_FRAME_LEN = struct.Struct("!I")
_REC_HEAD = struct.Struct("!cBII")
_FLAG_DOWNGRADED = 1
_FLAG_REUSED = 2


def _read_exact(f, n: int) -> Optional[bytes]:
    """Read exactly ``n`` bytes from a socket file, None on EOF."""
    chunks = []
    while n:
        chunk = f.read(n)
        if not chunk:
            return None
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def run_stream_load(
    url: str,
    payloads: List[bytes],
    streams: int = 4,
    frames: int = 16,
    fps: float = 10.0,
    budget_ms: Optional[float] = None,
    window: Optional[int] = None,
    tier: Optional[str] = None,
    allow_downgrade: bool = False,
    timeout: float = 120.0,
    window_sec: float = DEFAULT_WINDOW_SEC,
    per_worker: bool = False,
    reuse_threshold: Optional[float] = None,
    max_reuse_run: Optional[int] = None,
    reuse_warp: bool = False,
    keep_frames: bool = False,
) -> Dict:
    """Replay ``payloads`` as ``streams`` paced concurrent POST /stream
    sessions (``frames`` frames each at ``fps``); returns the aggregate
    per-frame accounting report.

    Open-loop per stream ON PURPOSE — a live camera does not slow down
    because the server is busy, so frame ``i`` is sent at
    ``t0 + i/fps`` regardless of what came back. Every sent frame ends
    in exactly one bucket: ``ok`` (enhanced frame delivered, its
    end-to-end latency sampled), ``dropped`` (explicit drop record:
    window overflow / queue shed / disconnect cleanup),
    ``out_of_budget`` (drop record with reason ``budget``),
    ``frame_errors`` (per-frame error record), or — when the connection
    died under the session — ``conn_reset`` / ``errors`` absorb the
    unaccounted remainder, split exactly as in :func:`run_load` (a
    graceful close is not a crash). ``refused`` counts sessions the
    server turned away at admission (503, degradation rung 3);
    ``downgraded`` counts delivered frames served by the fast tier
    under brown-out (the record's downgrade flag). ``per_worker=True``
    adds ``per_worker_sessions`` — accepted sessions counted by the
    ``X-Worker-Id`` on the response head, pinning which fleet worker
    each session landed on (docs/SERVING.md "Fleet").

    ``reuse_threshold`` opts the sessions into server-side temporal
    reuse (``X-Stream-Reuse``, docs/SERVING.md "Temporal reuse"):
    near-static frames come back as reuse records (wire kind ``R``),
    counted in ``reused`` — delivered answers that skipped compute, so
    the effective rate is ``(ok + reused)`` per stream-second and
    ``fps_per_stream`` counts both. ``max_reuse_run`` forwards the
    staleness cap (``X-Stream-Max-Reuse-Run``) and ``reuse_warp``
    enables coarse motion-compensated reuse (``X-Stream-Reuse-Warp``).
    ``keep_frames=True`` additionally returns ``frames`` — per stream
    index, the ordered ``(seq, kind, payload_bytes)`` of every
    delivered frame — so a bench can measure flicker on exactly what a
    viewer would see.
    """
    import socket

    u = urlparse(url)
    host, port = u.hostname, u.port or 80
    run_tag = new_request_id()[:8]
    lock = threading.Lock()
    counts = {
        "ok": 0, "reused": 0, "dropped": 0, "out_of_budget": 0,
        "frame_errors": 0, "downgraded": 0, "refused": 0, "conn_reset": 0,
        "errors": 0,
    }
    totals = {"frames_sent": 0}
    latencies: List[float] = []
    samples: List = []  # (t_recv - t_run0, latency_sec) delivered frames
    failures: List[Dict] = []
    session_workers: Dict[str, int] = {}  # X-Worker-Id -> sessions
    frames_out: Dict[int, List] = {}  # stream idx -> [(seq, kind, bytes)]

    def record_failure(rec: Dict) -> None:
        # Caller holds `lock`.
        if len(failures) < MAX_FAILURE_RECORDS:
            failures.append(rec)

    def stream_worker(si: int):
        rid = f"lg-{run_tag}-s{si}"
        t_sent: Dict[int, float] = {}
        accounted = 0  # frames that got a record (or a refusal)
        sent = 0
        reset = False
        sock = None
        try:
            sock = socket.create_connection((host, port), timeout=timeout)
            head = (
                "POST /stream HTTP/1.1\r\n"
                f"Host: {host}:{port}\r\n"
                f"X-Request-Id: {rid}\r\n"
                f"X-Stream-Fps: {fps}\r\n"
            )
            if budget_ms is not None:
                head += f"X-Stream-Budget-Ms: {budget_ms}\r\n"
            if window is not None:
                head += f"X-Stream-Window: {window}\r\n"
            if tier is not None:
                head += f"X-Tier: {tier}\r\n"
            if allow_downgrade:
                head += "X-Tier-Allow-Downgrade: 1\r\n"
            if reuse_threshold is not None:
                head += f"X-Stream-Reuse: {reuse_threshold}\r\n"
            if max_reuse_run is not None:
                head += f"X-Stream-Max-Reuse-Run: {max_reuse_run}\r\n"
            if reuse_warp:
                head += "X-Stream-Reuse-Warp: 1\r\n"
            head += "\r\n"
            sock.sendall(head.encode("latin-1"))
            f = sock.makefile("rb")
            status_line = f.readline()
            status = int(status_line.split()[1]) if status_line else 0
            wid = None
            while True:  # response headers: keep the worker stamp only
                line = f.readline()
                if not line or line in (b"\r\n", b"\n"):
                    break
                name, _, value = line.decode("latin-1").partition(":")
                if name.strip().lower() == "x-worker-id":
                    wid = value.strip() or None
            if status == 200 and per_worker:
                with lock:
                    key = wid or "unattributed"
                    session_workers[key] = session_workers.get(key, 0) + 1
            if status != 200:
                with lock:
                    outcome = "refused" if status == 503 else "errors"
                    counts[outcome] += 1
                    record_failure({
                        "request_id": rid,
                        "outcome": outcome,
                        "status": status,
                    })
                return

            done = threading.Event()

            def sender():
                nonlocal sent
                t0 = time.perf_counter()
                try:
                    for i in range(frames):
                        lag = t0 + i / fps - time.perf_counter()
                        if lag > 0:
                            time.sleep(lag)
                        payload = payloads[i % len(payloads)]
                        with lock:
                            t_sent[i] = time.perf_counter()
                        sock.sendall(
                            _FRAME_LEN.pack(len(payload)) + payload
                        )
                        sent += 1
                    sock.sendall(_FRAME_LEN.pack(0))  # clean end
                except OSError:
                    pass  # server closed mid-upload; reader accounts
                finally:
                    done.set()

            tx = threading.Thread(
                target=sender,
                name=f"{THREAD_PREFIX}-stream-tx-{si}",
                daemon=True,
            )
            tx.start()
            try:
                while True:
                    raw = _read_exact(f, _REC_HEAD.size)
                    if raw is None:
                        reset = True  # session ended without a Z record
                        break
                    kind, flags, seq, n = _REC_HEAD.unpack(raw)
                    payload = _read_exact(f, n) if n else b""
                    if n and payload is None:
                        reset = True
                        break
                    t_recv = time.perf_counter()
                    if kind == b"Z":
                        break
                    with lock:
                        accounted += 1
                        if kind in (b"F", b"R"):
                            counts["ok" if kind == b"F" else "reused"] += 1
                            if flags & _FLAG_DOWNGRADED:
                                counts["downgraded"] += 1
                            if kind == b"F" and seq in t_sent:
                                latencies.append(t_recv - t_sent[seq])
                                samples.append(
                                    (t_recv - t_run0, t_recv - t_sent[seq])
                                )
                            if keep_frames:
                                frames_out.setdefault(si, []).append(
                                    (seq, kind.decode("latin-1"), payload)
                                )
                        elif kind == b"D":
                            reason = json.loads(payload).get("reason")
                            counts[
                                "out_of_budget"
                                if reason == "budget"
                                else "dropped"
                            ] += 1
                        else:  # b"E"
                            counts["frame_errors"] += 1
            except OSError:
                reset = True
            done.wait(timeout)
        except OSError as err:
            with lock:
                key = (
                    "conn_reset"
                    if isinstance(
                        err, (ConnectionResetError, BrokenPipeError)
                    )
                    else "errors"
                )
                counts[key] += 1
                record_failure({
                    "request_id": rid,
                    "outcome": key,
                    "error": type(err).__name__,
                })
        finally:
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
            with lock:
                totals["frames_sent"] += sent
                # Frames sent but never answered by any record: the
                # connection died under them. conn_reset, not silence.
                if reset and sent > accounted:
                    counts["conn_reset"] += sent - accounted
                    record_failure({
                        "request_id": rid,
                        "outcome": "conn_reset",
                        "frames_unaccounted": sent - accounted,
                    })

    threads = [
        threading.Thread(
            target=stream_worker,
            args=(i,),
            name=f"{THREAD_PREFIX}-stream-{i}",
            daemon=True,
        )
        for i in range(max(1, int(streams)))
    ]
    t_run0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = time.perf_counter() - t_run0

    lat_sorted = sorted(latencies)
    # Delivered = computed + reused: a reuse record is a real answer on
    # the wire, it just skipped the device. With reuse off (the
    # default) reused is 0 and this is the old ok-only figure.
    delivered = counts["ok"] + counts["reused"]
    per_worker_block = (
        {"per_worker_sessions": session_workers} if per_worker else {}
    )
    frames_block = {"frames": frames_out} if keep_frames else {}
    return {
        **per_worker_block,
        **frames_block,
        "streams": int(streams),
        "frames_per_stream": int(frames),
        "offered_fps": float(fps),
        **totals,
        **counts,
        "fps_per_stream": (
            round(delivered / max(1, int(streams)) / elapsed, 2)
            if elapsed else 0.0
        ),
        "elapsed_sec": round(elapsed, 3),
        "frame_latency_ms": {
            "p50": round(_percentile(lat_sorted, 0.50) * 1e3, 3),
            "p99": round(_percentile(lat_sorted, 0.99) * 1e3, 3),
        },
        "window": _window_block(samples, window_sec, now=elapsed),
        "request_id_prefix": f"lg-{run_tag}",
        "failures": failures,
    }


def _synthetic_payloads(spec: str, n: int = 8) -> List[bytes]:
    """``HxW`` -> n deterministic PNG payloads (no dataset needed)."""
    import cv2
    import numpy as np

    h, w = (int(x) for x in spec.lower().split("x"))
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        ok, buf = cv2.imencode(".png", img)
        assert ok
        out.append(buf.tobytes())
    return out


def _stream_payloads(
    spec: str, n: int = 16, static_pct: int = 0, pan_px: int = 0,
) -> List[bytes]:
    """``HxW`` -> n deterministic PNG frames with a controlled
    redundancy mix, the input for temporal-reuse benchmarking.

    ``static_pct`` of the frames repeat their predecessor exactly (the
    pattern is deterministic: frame ``i`` changes content only when
    ``i * (100 - static_pct) // 100`` advances, so a 75%-static run is
    the same frames every time). When the content does change it is a
    fresh scene unless ``pan_px`` is set, in which case the scene pans
    — ``np.roll`` by ``pan_px`` columns per change — which a
    block-flow-warping gate can still reuse but a plain delta gate
    treats as motion. With ``static_pct=0, pan_px=0`` every frame is an
    independent scene (the always-compute control mix).
    """
    import cv2
    import numpy as np

    if not 0 <= int(static_pct) <= 100:
        raise ValueError("static_pct must be in [0, 100]")
    h, w = (int(x) for x in spec.lower().split("x"))
    rng = np.random.default_rng(0)
    # Structured base scene (smooth gradients + texture) rather than
    # pure noise: block matching on noise is meaningless, and real
    # camera frames are compressible structure, not static snow.
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack(
        [
            127 + 90 * np.sin(xx / 11.0) * np.cos(yy / 7.0),
            127 + 90 * np.cos(xx / 5.0 + yy / 13.0),
            rng.integers(0, 256, (h, w)).astype(np.float32),
        ],
        axis=-1,
    ).clip(0, 255).astype(np.uint8)
    out = []
    img = base
    fresh = (100 - int(static_pct))
    for i in range(n):
        changed = i == 0 or (i * fresh) // 100 != ((i - 1) * fresh) // 100
        if changed and i > 0:
            if pan_px:
                img = np.roll(img, int(pan_px), axis=1)
            else:
                img = np.asarray(
                    rng.integers(0, 256, (h, w, 3)), dtype=np.uint8
                )
        ok, buf = cv2.imencode(".png", img)
        assert ok
        out.append(buf.tobytes())
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="waternet-loadgen", description=__doc__
    )
    parser.add_argument("--url", type=str, required=True)
    parser.add_argument(
        "--source", type=str, default=None,
        help="Directory of images to POST (defaults to synthetic frames).",
    )
    parser.add_argument(
        "--synthetic", type=str, default="112x150",
        help="HxW of synthetic payloads when --source is not given.",
    )
    parser.add_argument("--concurrency", type=int, default=4)
    parser.add_argument("--requests", type=int, default=64)
    parser.add_argument("--deadline-ms", type=float, default=None)
    parser.add_argument(
        "--arrival-rate", type=float, default=None, metavar="RPS",
        help="Open-loop Poisson arrivals at this rate (req/s) instead "
        "of closed-loop pacing: requests fire on a seeded exponential "
        "schedule regardless of responses; --concurrency then bounds "
        "only in-flight parallelism (request mode only).",
    )
    parser.add_argument(
        "--rate-ramp", type=str, default=None, metavar="SEC:RPS,...",
        help="Piecewise-constant open-loop rate profile, e.g. "
        "'0:20,10:200,20:20' — 20 req/s, surge to 200 at t=10 s, back "
        "at t=20 s (request mode only; excludes --arrival-rate).",
    )
    parser.add_argument(
        "--arrival-seed", type=int, default=0,
        help="PRNG seed for the Poisson schedule (same seed + rate = "
        "identical offered trace, for A/B runs).",
    )
    parser.add_argument(
        "--window-sec", type=float, default=DEFAULT_WINDOW_SEC,
        help="Trailing span of the report's 'window' block "
        "(throughput + p50/p99 over only the last N seconds of "
        "completions — the figure to read on a long degrading run).",
    )
    parser.add_argument(
        "--ledger", type=str, default=None,
        help="Write every request's {t, latency_ms, outcome} to this "
        "JSON file — replayable offline against an SLO spec with "
        "'waternet-trace slo LEDGER --slo ...' (request mode only).",
    )
    parser.add_argument(
        "--tier", type=str, default=None,
        choices=["quality", "fast"],
        help="Forwarded as X-Tier (default: no header, the server's "
        "default tier).",
    )
    parser.add_argument(
        "--allow-downgrade", action="store_true", default=False,
        help="Opt this traffic into brown-out downgrades "
        "(X-Tier-Allow-Downgrade: 1): under saturation the server may "
        "serve quality requests from the fast tier instead of shedding "
        "— the report's 'downgraded' counts how often it did.",
    )
    parser.add_argument(
        "--per-worker", action="store_true", default=False,
        help="Split the accounting by the X-Worker-Id each answer was "
        "stamped with (docs/SERVING.md 'Fleet'): request mode adds a "
        "'per_worker' counts block (and worker ids to --ledger "
        "entries), stream mode adds 'per_worker_sessions'. Answers "
        "without the header land under 'unattributed'.",
    )
    parser.add_argument(
        "--stream", action="store_true", default=False,
        help="Stream mode: replay the payloads as N paced concurrent "
        "POST /stream sessions (open-loop, like live cameras) with "
        "per-frame latency/drop/downgrade accounting instead of "
        "closed-loop /enhance requests.",
    )
    parser.add_argument(
        "--streams", type=int, default=4,
        help="Concurrent stream sessions (--stream mode).",
    )
    parser.add_argument(
        "--frames", type=int, default=16,
        help="Frames per stream (--stream mode).",
    )
    parser.add_argument(
        "--fps", type=float, default=10.0,
        help="Paced frame rate per stream, declared to the server as "
        "X-Stream-Fps (--stream mode).",
    )
    parser.add_argument(
        "--budget-ms", type=float, default=None,
        help="Per-frame freshness budget (X-Stream-Budget-Ms); default: "
        "the server derives 3000/fps (--stream mode).",
    )
    parser.add_argument(
        "--window", type=int, default=None,
        help="Per-stream delivery window (X-Stream-Window); default: "
        "the server's --stream-window (--stream mode).",
    )
    parser.add_argument(
        "--static-pct", type=int, default=None, metavar="PCT",
        help="Generate stream payloads where PCT%% of frames repeat "
        "their predecessor exactly (deterministic redundancy mix for "
        "temporal-reuse runs; --stream mode, replaces --synthetic "
        "noise frames).",
    )
    parser.add_argument(
        "--pan-px", type=int, default=0,
        help="When the generated scene changes, pan it by this many "
        "pixels instead of cutting to a fresh scene (exercises the "
        "warp path; needs --static-pct).",
    )
    parser.add_argument(
        "--reuse-threshold", type=float, default=None,
        help="Opt into server-side temporal reuse at this frame-delta "
        "threshold (X-Stream-Reuse); the report's 'reused' counts "
        "answers served from the reuse gate (--stream mode).",
    )
    parser.add_argument(
        "--max-reuse-run", type=int, default=None,
        help="Staleness cap forwarded as X-Stream-Max-Reuse-Run: at "
        "most N consecutive reused frames before a forced recompute.",
    )
    parser.add_argument(
        "--reuse-warp", action="store_true", default=False,
        help="Enable coarse motion-compensated reuse "
        "(X-Stream-Reuse-Warp: 1) for slow pans.",
    )
    args = parser.parse_args(argv)
    if args.arrival_rate is not None and args.rate_ramp is not None:
        print("--arrival-rate and --rate-ramp are exclusive",
              file=sys.stderr)
        return 2

    if args.source:
        from pathlib import Path

        payloads = [
            p.read_bytes()
            for p in sorted(Path(args.source).glob("*"))
            if p.suffix.lower() in (".png", ".jpg", ".jpeg", ".bmp")
        ]
        if not payloads:
            print(f"no images under {args.source}", file=sys.stderr)
            return 2
    elif args.stream and args.static_pct is not None:
        payloads = _stream_payloads(
            args.synthetic, n=max(args.frames, 1),
            static_pct=args.static_pct, pan_px=args.pan_px,
        )
    else:
        payloads = _synthetic_payloads(args.synthetic)
    if args.stream:
        report = run_stream_load(
            args.url,
            payloads,
            streams=args.streams,
            frames=args.frames,
            fps=args.fps,
            budget_ms=args.budget_ms,
            window=args.window,
            tier=args.tier,
            allow_downgrade=args.allow_downgrade,
            window_sec=args.window_sec,
            per_worker=args.per_worker,
            reuse_threshold=args.reuse_threshold,
            max_reuse_run=args.max_reuse_run,
            reuse_warp=args.reuse_warp,
        )
        print(json.dumps(report))
        return 0
    report = run_load(
        args.url,
        payloads,
        concurrency=args.concurrency,
        total=args.requests,
        deadline_ms=args.deadline_ms,
        tier=args.tier,
        allow_downgrade=args.allow_downgrade,
        window_sec=args.window_sec,
        collect_ledger=args.ledger is not None,
        per_worker=args.per_worker,
        arrival_rate=args.arrival_rate,
        rate_ramp=(
            parse_rate_ramp(args.rate_ramp)
            if args.rate_ramp is not None else None
        ),
        arrival_seed=args.arrival_seed,
    )
    if args.ledger is not None:
        from pathlib import Path

        Path(args.ledger).write_text(
            json.dumps({"ledger": report.pop("ledger", [])})
        )
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
