"""Stream sessions in the port (waternet_tpu_torch/serving/streams.py and the
server's ``POST /stream``), on the CPU, mirroring tests/test_streams.py:
in-order bit identity under re-dispatch, budget drops un-computed, window
drop-oldest, stall isolation, inline brown-out, admission refusal that
spares established streams, disconnect cleanup, frame-corrupt quarantine;
then the pins against the JAX package.

Bounds: a delivered frame's PNG decodes to exactly the port's offline
``enhance_padded`` for it (same bucket, same slot count), and its bytes
equal the port's own ``/enhance`` answer for the same upload. Against the
JAX server on the same frames, fault plan and reuse threshold the record
sequence (kind, flags, seq, drop reason) is equal, and ``F`` payloads are
within the engines' one-level bound (tests/test_torch_serving.py).

Every server binds ``127.0.0.1:0`` and is function-scoped, so the conftest
thread-leak guard proves a full shutdown after each test; every socket
read and join has a timeout.
"""

import http.client
import json
import os
import socket
import time
from pathlib import Path

import cv2
import numpy as np
import pytest

from waternet_tpu.serving import streams as jax_streams
from waternet_tpu_torch.inference_engine import InferenceEngine, StudentEngine
from waternet_tpu_torch.resilience import faults
from waternet_tpu_torch.serving import BucketLadder, SupervisionConfig
from waternet_tpu_torch.serving import streams
from waternet_tpu_torch.serving.loadgen import run_stream_load
from waternet_tpu_torch.serving.server import ServingServer
from waternet_tpu_torch.serving.streams import (
    FLAG_DOWNGRADED,
    FLAG_REUSED,
    FRAME_LEN,
    KIND_DROP,
    KIND_END,
    KIND_ERROR,
    KIND_FRAME,
    KIND_REUSED,
    REC_HEAD,
    StreamConfig,
)

REPO = Path(__file__).resolve().parent.parent
TEACHER = str(REPO / "tests" / "fixtures" / "distill" / "teacher.npz")
STUDENT = str(REPO / "tests" / "fixtures" / "distill" / "student.npz")
BUCKET = (32, 32)
MAX_BATCH = 4

pytestmark = pytest.mark.usefixtures("locktrace", "looptrace")


@pytest.fixture(scope="module")
def engine():
    return InferenceEngine(weights=TEACHER, device="cpu")


@pytest.fixture(autouse=True)
def _no_leftover_fault_plan():
    yield
    faults.clear()


def _start(engine, **kw):
    kw.setdefault("max_batch", MAX_BATCH)
    kw.setdefault("max_wait_ms", 30)
    kw.setdefault("max_queue", 64)
    kw.setdefault("replicas", 1)
    srv = ServingServer(engine, BucketLadder([BUCKET]), **kw)
    srv.start_background()
    srv.wait_ready(timeout=120)
    return srv


def _stop(srv):
    srv.request_drain()
    assert srv.join(timeout=120) == 0


@pytest.fixture
def server(engine):
    srv = _start(engine)
    yield srv
    _stop(srv)


def _frames(rng, shapes):
    return [np.asarray(rng.integers(0, 256, (h, w, 3)), dtype=np.uint8) for h, w in shapes]


def _png(rgb):
    ok, buf = cv2.imencode(".png", rgb[:, :, ::-1])
    assert ok
    return buf.tobytes()


def _rgb(body):
    bgr = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
    assert bgr is not None
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def _expected_offline(engine, rgb):
    h, w = rgb.shape[:2]
    return engine.enhance_padded([rgb], BUCKET, n_slots=MAX_BATCH)[0, :h, :w]


def _get_json(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60.0)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _post(port, path, body, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60.0)
    try:
        conn.request("POST", path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}, resp.read()
    finally:
        conn.close()


def _wait_for(cond, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


# -- raw stream client: the protocol-level assertions loadgen abstracts away --


def _open_stream(port, headers=None, timeout=60.0):
    sock = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    lines = ["POST /stream HTTP/1.1", f"Host: 127.0.0.1:{port}"]
    lines += [f"{k}: {v}" for k, v in (headers or {}).items()]
    sock.sendall(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1"))
    f = sock.makefile("rb")
    status = int(f.readline().split()[1])
    hdrs = {}
    while True:
        line = f.readline()
        if not line or line in (b"\r\n", b"\n"):
            break
        k, _, v = line.decode("latin-1").partition(":")
        hdrs[k.strip().lower()] = v.strip()
    return sock, f, status, hdrs


def _send_frame(sock, payload):
    sock.sendall(FRAME_LEN.pack(len(payload)) + payload)


def _send_end(sock):
    sock.sendall(FRAME_LEN.pack(0))


def _read_records(f):
    recs = []
    while True:
        head = f.read(REC_HEAD.size)
        if len(head) < REC_HEAD.size:
            break
        kind, flags, seq, n = REC_HEAD.unpack(head)
        recs.append((kind, flags, seq, f.read(n) if n else b""))
        if kind == KIND_END:
            break
    return recs


def _session(port, payloads, headers):
    sock, f, status, hdrs = _open_stream(port, headers)
    try:
        assert status == 200, status
        for p in payloads:
            _send_frame(sock, p)
        _send_end(sock)
        return hdrs, _read_records(f)
    finally:
        sock.close()


def _summary(recs):
    assert recs and recs[-1][0] == KIND_END, recs
    return json.loads(recs[-1][3])


# ---------------------------------------------------------------------------
# In order, bit for bit the offline path, under re-dispatch
# ---------------------------------------------------------------------------


def test_stream_in_order_bit_identity_under_redispatch(engine):
    """replica_crash@1 + replica_hang@2 on a 2-replica pool under one
    stream: every frame delivered, in submit order, each byte-identical to
    the offline ``enhance_padded``, and nothing met cold."""
    srv = _start(engine, replicas=2,
                 supervision=SupervisionConfig(watchdog_sec=1.0, scan_interval_sec=0.005, rewarm_backoff_sec=0.01))
    frames = _frames(np.random.default_rng(0), [(30, 30), (32, 32), (28, 31), (31, 26), (29, 32)])
    try:
        expected = [_expected_offline(engine, rgb) for rgb in frames]
        cold = engine.cold_dispatches
        faults.install(faults.FaultPlan.parse("replica_crash@1,replica_hang@2"))
        try:
            hdrs, recs = _session(srv.bound_port, [_png(f) for f in frames],
                                  {"X-Stream-Fps": "30", "X-Stream-Budget-Ms": "60000", "X-Stream-Window": "16"})
        finally:
            faults.clear()  # releases the hang latch for the retired thread
        assert hdrs["content-type"] == "application/x-waternet-stream" and hdrs["x-request-id"]
        assert "x-worker-id" not in hdrs
        assert [r[0] for r in recs[:-1]] == [KIND_FRAME] * len(frames)
        assert [r[2] for r in recs[:-1]] == list(range(len(frames)))
        for (_, flags, _, body), ref in zip(recs[:-1], expected):
            assert flags == 0
            np.testing.assert_array_equal(_rgb(body), ref)
        z = _summary(recs)
        assert (z["frames_in"], z["delivered"], z["dropped"], z["out_of_budget"], z["errors"]) == (5, 5, 0, 0, 0)
        assert engine.cold_dispatches == cold
    finally:
        _stop(srv)
    summary = srv.stats.summary()
    assert summary["compiles"] == 2 and summary["fallback_native_shapes"] == 0
    assert summary["retried"] >= 1  # the faults really fired
    assert summary["streams"]["frames_delivered"] == len(frames)


# ---------------------------------------------------------------------------
# Bounded latency: budget drops, drop-oldest
# ---------------------------------------------------------------------------


def test_stream_budget_expiry_drops_uncomputed(server):
    """A 1 ms budget with spaced frames: each frame's deadline is gone by
    dispatch, so the batcher drops it un-computed and the session answers
    a ``budget`` drop record in sequence position."""
    payload = _png(_frames(np.random.default_rng(1), [(30, 30)])[0])
    sock, f, status, _ = _open_stream(server.bound_port, {"X-Stream-Budget-Ms": "1"})
    assert status == 200
    for _ in range(3):
        _send_frame(sock, payload)
        time.sleep(0.05)
    _send_end(sock)
    recs = _read_records(f)
    sock.close()
    assert [r[0] for r in recs[:-1]] == [KIND_DROP] * 3 and [r[2] for r in recs[:-1]] == [0, 1, 2]
    assert all(json.loads(r[3])["reason"] == "budget" for r in recs[:-1])
    z = _summary(recs)
    assert z["out_of_budget"] == 3 and z["delivered"] == 0
    _, stats = _get_json(server.bound_port, "/stats")
    st = stats["streams"]
    assert (st["frames_in"], st["frames_out_of_budget"], st["frames_delivered"]) == (3, 3, 0)
    assert stats["batches"] == 0  # dropped deliberately, never computed


def test_stream_window_drop_oldest_under_stalled_consumer(server, monkeypatch):
    """stream_stall@1 wedges the session's own delivery; with window 1 the
    drop-oldest policy sheds the backlog: one record a frame, in order,
    the newest work surviving."""
    payload = _png(_frames(np.random.default_rng(2), [(30, 30)])[0])
    monkeypatch.setenv("WATERNET_FAULT_STALL_SEC", "0.2")
    faults.install(faults.FaultPlan.parse("stream_stall@1"))
    hdrs, recs = _session(server.bound_port, [payload] * 5, {"X-Stream-Window": "1", "X-Stream-Budget-Ms": "60000"})
    kinds = [r[0] for r in recs[:-1]]
    assert [r[2] for r in recs[:-1]] == list(range(5))
    assert set(kinds) <= {KIND_FRAME, KIND_DROP}
    assert kinds.count(KIND_DROP) >= 3 and kinds.count(KIND_FRAME) >= 1
    assert all(json.loads(r[3])["reason"] == "window" for r in recs[:-1] if r[0] == KIND_DROP)
    z = _summary(recs)
    assert z["delivered"] + z["dropped"] == 5 and (z["out_of_budget"], z["errors"]) == (0, 0)
    assert _get_json(server.bound_port, "/stats")[1]["streams"]["frames_dropped"] >= 3


def test_stalled_stream_never_delays_healthy_stream(server, monkeypatch):
    """A wedged consumer (each delivery stalls 0.5 s) backpressures only
    its own session: a healthy paced stream beside it keeps its latency,
    far under the stalled session's multi-second delivery tail."""
    payload = _png(_frames(np.random.default_rng(3), [(30, 30)])[0])
    monkeypatch.setenv("WATERNET_FAULT_STALL_SEC", "0.5")
    faults.install(faults.FaultPlan.parse("stream_stall@1"))
    sock, f, status, _ = _open_stream(server.bound_port, {"X-Stream-Window": "2", "X-Stream-Budget-Ms": "60000"})
    try:
        assert status == 200
        for _ in range(6):
            _send_frame(sock, payload)
        report = run_stream_load(server.url, [payload], streams=1, frames=6, fps=50.0, budget_ms=5000.0, window=8,
                                 timeout=60.0)
        _send_end(sock)
        recs = _read_records(f)
    finally:
        sock.close()
    assert report["ok"] == 6 and report["conn_reset"] == 0 and report["errors"] == 0, report
    assert report["frame_latency_ms"]["p99"] < 2500.0, report
    z = _summary(recs)
    assert z["delivered"] + z["dropped"] == 6 and z["errors"] == 0


# ---------------------------------------------------------------------------
# Rung 1: per-frame brown-out (opt-in only); rung 3: admission refusal
# ---------------------------------------------------------------------------


def test_stream_brownout_downgrades_frames_inline(engine, monkeypatch):
    """slow_replica@1 holds the first quality batch, so the quality backlog
    sits at the brown-out watermark when the next frames arrive: the
    opted-in stream's later frames are served by the student, flagged
    ``FLAG_DOWNGRADED``, byte-equal to its ``enhance_padded``."""
    fast = StudentEngine(weights=STUDENT, device="cpu")
    srv = _start(engine, max_wait_ms=10, fast_engine=fast, downgrade_watermark=1)
    rgb = _frames(np.random.default_rng(4), [(30, 30)])[0]
    payload = _png(rgb)
    monkeypatch.setenv("WATERNET_FAULT_SLOW_SEC", "0.6")
    faults.install(faults.FaultPlan.parse("slow_replica@1"))
    try:
        sock, f, status, _ = _open_stream(srv.bound_port, {"X-Tier": "quality", "X-Tier-Allow-Downgrade": "1",
                                                          "X-Stream-Budget-Ms": "60000"})
        assert status == 200
        _send_frame(sock, payload)
        time.sleep(0.25)  # frame 0's quality batch is launched (and held)
        for _ in range(3):
            _send_frame(sock, payload)
        _send_end(sock)
        recs = _read_records(f)
        sock.close()
    finally:
        faults.clear()
        _stop(srv)
    assert [r[0] for r in recs[:-1]] == [KIND_FRAME] * 4 and [r[2] for r in recs[:-1]] == [0, 1, 2, 3]
    flags = [r[1] for r in recs[:-1]]
    assert flags[0] == 0 and all(fl & FLAG_DOWNGRADED for fl in flags[1:]), flags
    np.testing.assert_array_equal(_rgb(recs[0][3]), _expected_offline(engine, rgb))
    for r in recs[1:-1]:
        np.testing.assert_array_equal(_rgb(r[3]), _expected_offline(fast, rgb))
    z = _summary(recs)
    assert z["delivered"] == 4 and z["downgraded"] == 3
    assert srv.stats.summary()["streams"]["downgrades"] == 3


def test_stream_admission_refusal_spares_established_stream(engine):
    """max_streams=1: the second session is refused (503 + Retry-After,
    counted) while the established one keeps delivering; /healthz carries
    the live ``active_streams`` gauge."""
    srv = _start(engine, max_streams=1)
    payload = _png(_frames(np.random.default_rng(5), [(30, 30)])[0])
    try:
        sock, f, status, _ = _open_stream(srv.bound_port, {"X-Stream-Budget-Ms": "60000"})
        assert status == 200
        _send_frame(sock, payload)
        _wait_for(lambda: _get_json(srv.bound_port, "/healthz")[1]["active_streams"] == 1, what="active_streams")
        s2, f2, status2, hdrs2 = _open_stream(srv.bound_port, {})
        assert status2 == 503 and "retry-after" in hdrs2
        f2.read()
        s2.close()
        _, stats = _get_json(srv.bound_port, "/stats")
        assert stats["streams"]["refused"] == 1 and stats["streams"]["active_streams"] == 1
        _send_frame(sock, payload)
        _send_end(sock)
        recs = _read_records(f)
        sock.close()
        assert [r[0] for r in recs[:-1]] == [KIND_FRAME, KIND_FRAME] and _summary(recs)["delivered"] == 2
    finally:
        _stop(srv)


# ---------------------------------------------------------------------------
# Disconnect cleanup, per-frame decode quarantine
# ---------------------------------------------------------------------------


def test_stream_disconnect_cancels_only_its_frames(server):
    """stream_disconnect@1 kills the first session after 2 frames: the
    client books the rest as conn_reset, the server books disconnect
    drops, and the next session on the same server is untouched."""
    payload = _png(_frames(np.random.default_rng(6), [(30, 30)])[0])
    faults.install(faults.FaultPlan.parse("stream_disconnect@1"))
    try:
        report = run_stream_load(server.url, [payload], streams=1, frames=5, fps=100.0, budget_ms=5000.0,
                                 timeout=60.0)
    finally:
        faults.clear()
    assert report["conn_reset"] >= 1 and report["errors"] == 0 and report["refused"] == 0, report
    assert (report["ok"] + report["dropped"] + report["out_of_budget"] + report["frame_errors"]
            + report["conn_reset"]) == report["frames_sent"]
    _wait_for(lambda: _get_json(server.bound_port, "/healthz")[1]["active_streams"] == 0, what="session cleanup")
    assert _get_json(server.bound_port, "/stats")[1]["streams"]["frames_dropped"] >= 1
    report2 = run_stream_load(server.url, [payload], streams=1, frames=3, fps=50.0, budget_ms=10000.0,
                              timeout=60.0)
    assert report2["ok"] == 3 and report2["conn_reset"] == 0 and report2["errors"] == 0, report2


def test_frame_corrupt_quarantines_only_its_frame(server):
    """frame_corrupt@2 and a genuinely undecodable payload: each bad frame
    is an ``E`` record in its own position; the stream lives on."""
    good = _png(_frames(np.random.default_rng(7), [(30, 30)])[0])
    faults.install(faults.FaultPlan.parse("frame_corrupt@2"))
    _, recs = _session(server.bound_port, [good, good, good, b"definitely not an image"],
                       {"X-Stream-Budget-Ms": "60000"})
    assert [r[0] for r in recs[:-1]] == [KIND_FRAME, KIND_ERROR, KIND_FRAME, KIND_ERROR]
    assert [r[2] for r in recs[:-1]] == [0, 1, 2, 3]
    assert all("decodable" in json.loads(recs[i][3])["error"] for i in (1, 3))
    z = _summary(recs)
    assert (z["delivered"], z["errors"], z["dropped"]) == (2, 2, 0)


def test_stream_route_answers_refusals_before_a_session(server):
    """Malformed headers, an unknown tier and an unconfigured fast tier are
    400s that open no session; ``--max-streams`` and the other stream
    knobs reach the server."""
    for headers, needle in (({"X-Stream-Fps": "0"}, b"X-Stream-Fps"), ({"X-Tier": "turbo"}, b"unknown tier"),
                            ({"X-Tier": "fast"}, b"fast tier not configured"),
                            ({"X-Stream-Reuse": "-1"}, b"X-Stream-Reuse")):
        sock, f, status, _ = _open_stream(server.bound_port, headers)
        body = f.read()
        sock.close()
        assert status == 400 and needle in body, (headers, body)
    assert _get_json(server.bound_port, "/stats")[1]["streams"]["opened"] == 0


# ---------------------------------------------------------------------------
# Pins against the JAX package
# ---------------------------------------------------------------------------


def test_wire_protocol_constants_equal_jax():
    """Byte compatibility: one ``run_stream_load`` client drives either
    package's server."""
    for name in ("FRAME_LEN", "REC_HEAD"):
        assert getattr(streams, name).format == getattr(jax_streams, name).format
    for name in ("KIND_FRAME", "KIND_REUSED", "KIND_DROP", "KIND_ERROR", "KIND_END", "FLAG_DOWNGRADED",
                 "FLAG_REUSED", "MAX_FRAME_BYTES", "HARD_CAP_WINDOWS"):
        assert getattr(streams, name) == getattr(jax_streams, name), name


@pytest.mark.parametrize("headers", [
    {},
    {"x-stream-fps": "25", "x-tier": "Fast", "x-tier-allow-downgrade": "yes", "x-stream-window": "3"},
    {"x-stream-budget-ms": "120", "x-stream-reuse": "1.5", "x-stream-max-reuse-run": "4",
     "x-stream-reuse-warp": "1"},
    {"x-stream-reuse": "off"},
    {"x-stream-fps": "-1"},
    {"x-stream-window": "0"},
    {"x-stream-reuse": "-0.5"},
    {"x-stream-max-reuse-run": "0"},
])
def test_stream_config_from_headers_equals_jax(headers):
    def parse(mod):
        try:
            return vars(mod.StreamConfig.from_headers(headers, 6, default_reuse=2.0, default_max_reuse_run=9))
        except ValueError as err:
            return ("ValueError", str(err))

    assert parse(streams) == parse(jax_streams)
    assert isinstance(StreamConfig.from_headers({}, 8), StreamConfig)


@pytest.fixture(scope="module")
def jax_engine():
    from waternet_tpu.inference_engine import InferenceEngine as JaxEngine

    return JaxEngine(weights=TEACHER)


def test_stream_records_equal_jax_server_and_port_frames_equal_its_enhance(engine, jax_engine):
    """The same frames, the same ``frame_corrupt@5`` plan and reuse
    threshold 0 through a JAX ``ServingServer`` and the port's: the same
    record sequence (kind, flags, seq, drop reason); ``F`` payloads within
    one level of JAX's; every port ``F`` byte-equal to the port's own
    ``/enhance`` answer for that upload, and ``R`` the bytes of its anchor."""
    from waternet_tpu.resilience import faults as jax_faults
    from waternet_tpu.serving import BucketLadder as JaxLadder
    from waternet_tpu.serving.server import ServingServer as JaxServer

    a, b, c, d = _frames(np.random.default_rng(8), [(30, 30), (32, 29), (27, 32), (31, 31)])
    payloads = [_png(x) for x in (a, a, b, b, c, d)]
    headers = {"X-Stream-Budget-Ms": "60000", "X-Stream-Reuse": "0", "X-Stream-Window": "16"}

    def run(srv, fault_mod):
        fault_mod.install(fault_mod.FaultPlan.parse("frame_corrupt@5"))
        try:
            _, recs = _session(srv.bound_port, payloads, headers)
        finally:
            fault_mod.clear()
        return recs

    jsrv = JaxServer(jax_engine, JaxLadder([BUCKET]), max_batch=MAX_BATCH, max_wait_ms=30, replicas=1, max_queue=64)
    jsrv.start_background()
    try:
        jsrv.wait_ready(timeout=600)
        jrecs = run(jsrv, jax_faults)
    finally:
        jsrv.request_drain()
        assert jsrv.join(timeout=120) == 0
    srv = _start(engine)
    try:
        precs = run(srv, faults)
        enhance = [_post(srv.bound_port, "/enhance", p) for p in payloads]
    finally:
        _stop(srv)

    def shape(recs):
        return [(k, fl, seq, json.loads(body).get("reason") if k == KIND_DROP else None)
                for k, fl, seq, body in recs[:-1]]

    assert shape(precs) == shape(jrecs)
    assert [r[0] for r in precs[:-1]] == [KIND_FRAME, KIND_REUSED, KIND_FRAME, KIND_REUSED, KIND_ERROR,
                                          KIND_FRAME]
    assert [r[1] for r in precs[:-1]] == [0, FLAG_REUSED, 0, FLAG_REUSED, 0, 0]
    assert _summary(precs) == dict(_summary(jrecs), stream_id=_summary(precs)["stream_id"])
    for (kind, _, seq, body), (_, _, _, jbody) in zip(precs[:-1], jrecs[:-1]):
        if kind == KIND_ERROR:
            continue
        diff = np.abs(_rgb(body).astype(np.int16) - _rgb(jbody).astype(np.int16))
        assert diff.max() <= 1, (seq, int(diff.max()))
        status, _, answer = enhance[seq]
        assert status == 200 and body == answer, seq
