"""The port's HTTP front door (waternet_tpu_torch/serving/server.py) and
its clients, on the CPU: the routes, byte identity with the offline
``enhance_padded``, admission control and its accounting, deadlines,
drain, hot reload, ``/metrics`` against the JAX package's renderer, the
``--serve-url`` thin client, the server and loadgen CLIs, the CUDA-by-
default rule, and the bench's ``serve_http`` line.

Every server binds ``127.0.0.1:0`` and is function-scoped, so the
conftest thread-leak guard proves a full shutdown after each test; every
join and wait has a timeout.

Bounds: a response's PNG decodes to exactly the port's offline
``enhance_padded`` output for the same image (same bucket, same slot
count), cropped: PNG is lossless and the gateway adds transport, not
arithmetic. The ``/metrics`` text equals the JAX package's
``render_prometheus`` of the same summary dict, byte for byte.
"""

import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import cv2

from waternet_tpu.obs.prometheus import render_prometheus as jax_render_prometheus
from waternet_tpu_torch.hub import init_state_dict
from waternet_tpu_torch.inference_engine import InferenceEngine
from waternet_tpu_torch.resilience import faults
from waternet_tpu_torch.serving import BucketLadder, DeadlineExpired, DynamicBatcher, QueueFull
from waternet_tpu_torch.serving.loadgen import run_load
from waternet_tpu_torch.serving.server import ServingServer

REPO = Path(__file__).resolve().parent.parent
TEACHER = str(REPO / "tests" / "fixtures" / "distill" / "teacher.npz")
BUCKET = (32, 32)
MAX_BATCH = 4

pytestmark = pytest.mark.usefixtures("looptrace")


def photo(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack(
        [55 + 40 * np.sin(xx / 6 + c) + 30 * np.cos(yy / 5 + 2 * c) + 45 * c for c in range(3)],
        axis=-1,
    )
    return np.clip(base + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)


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
    srv = ServingServer(engine, BucketLadder([BUCKET]), **kw)
    srv.start_background()
    srv.wait_ready(timeout=120)
    return srv


@pytest.fixture
def server(engine):
    srv = _start(engine)
    yield srv
    srv.request_drain()
    assert srv.join(timeout=120) == 0


def _request(port, method, path, body=None, headers=None, timeout=60.0):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _png(img):
    ok, buf = cv2.imencode(".png", img)
    assert ok
    return buf.tobytes()


def _expected_offline(engine, rgb):
    h, w = rgb.shape[:2]
    return engine.enhance_padded([rgb], BUCKET, n_slots=MAX_BATCH)[0, :h, :w]


def _response_rgb(body):
    bgr = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
    assert bgr is not None
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def test_healthz_enhance_stats_metrics_and_routes(server, engine):
    port = server.bound_port
    status, _, body = _request(port, "GET", "/healthz")
    assert status == 200
    assert json.loads(body) == {
        "ready": True, "warmed": True, "draining": False, "status": "ok",
        "replicas": {"quality": {"0": "healthy"}},
    }
    bgr = photo(30, 30, 1)
    status, headers, body = _request(port, "POST", "/enhance", body=_png(bgr))
    assert status == 200 and headers["Content-Type"] == "image/png"
    assert headers["X-Tier-Served"] == "quality" and headers["X-Request-Id"]
    np.testing.assert_array_equal(_response_rgb(body), _expected_offline(engine, bgr[:, :, ::-1]))

    status, _, body = _request(port, "GET", "/stats")
    stats = json.loads(body)
    assert status == 200 and stats["requests"] >= 1 and stats["queue_depth"] == 0
    assert stats["compiles"] == 1 and stats["config"]["max_batch"] == MAX_BATCH
    status, headers, body = _request(port, "GET", "/metrics")
    assert status == 200 and headers["Content-Type"].startswith("text/plain")
    assert b"waternet_requests_total" in body

    assert _request(port, "GET", "/no-such-route")[0] == 404
    status, _, body = _request(port, "POST", "/enhance", body=b"not an image")
    assert status == 400 and b"not a decodable image" in body
    assert _request(port, "GET", "/enhance")[0] == 405
    status, headers, body = _request(port, "POST", "/stream", body=b"")
    assert status == 404 and b"item 6" in body and headers.get("Connection") == "close"
    status, _, body = _request(port, "POST", "/enhance", body=_png(bgr), headers={"X-Tier": "fast"})
    assert status == 400 and b"fast tier not configured" in body
    assert _request(port, "POST", "/enhance", body=_png(bgr), headers={"X-Tier": "turbo"})[0] == 400


def test_metrics_text_equals_jax_render_prometheus(server):
    """One vocabulary in both packages: the port's ``/metrics`` is the JAX
    renderer's text for the same summary dict."""
    from waternet_tpu_torch.obs.prometheus import render_prometheus

    port = server.bound_port
    assert _request(port, "POST", "/enhance", body=_png(photo(20, 28, 2)))[0] == 200
    summary = server.stats.summary()
    assert render_prometheus(summary) == jax_render_prometheus(summary)
    json.dumps(summary)  # the /stats body


def test_every_response_equals_offline_enhance_padded(server, engine):
    """Concurrent mixed-size requests through loadgen: each answer's bytes
    decode to the offline output of its own payload."""
    imgs = [photo(20 + 3 * i, 32 - 2 * i, 30 + i) for i in range(5)]
    payloads = [_png(im) for im in imgs]
    rep = run_load(server.url, payloads, concurrency=4, total=10, keep_bodies=True)
    assert rep["ok"] == 10 and rep["errors"] == 0
    for idx, status, body in rep["bodies"]:
        assert status == 200
        im = imgs[idx % len(imgs)]
        np.testing.assert_array_equal(_response_rgb(body), _expected_offline(engine, im[:, :, ::-1]))


def test_deadline_semantics_over_http(server, engine):
    port = server.bound_port
    before = json.loads(_request(port, "GET", "/stats")[2])
    bgr = photo(30, 30, 3)
    payload = _png(bgr)
    assert _request(port, "POST", "/enhance", body=payload, headers={"X-Deadline-Ms": "-5"})[0] == 504
    assert _request(port, "POST", "/enhance", body=payload, headers={"X-Deadline-Ms": "bogus"})[0] == 400
    # 3 ms against a 30 ms coalescing window: the deadline clamps the wait,
    # the request is found expired at dispatch and dropped un-computed.
    assert _request(port, "POST", "/enhance", body=payload, headers={"X-Deadline-Ms": "3"})[0] == 504
    status, _, body = _request(port, "POST", "/enhance", body=payload, headers={"X-Deadline-Ms": "60000"})
    assert status == 200
    np.testing.assert_array_equal(_response_rgb(body), _expected_offline(engine, bgr[:, :, ::-1]))
    after = json.loads(_request(port, "GET", "/stats")[2])
    assert after["deadline_expired"] - before["deadline_expired"] == 2
    assert after["requests"] - before["requests"] == 1


def test_min_deadline_floor_rejects_up_front(engine):
    srv = _start(engine, max_wait_ms=5, max_queue=16, min_deadline_ms=50.0)
    try:
        status, _, body = _request(srv.bound_port, "POST", "/enhance", body=_png(photo(20, 20, 4)),
                                   headers={"X-Deadline-Ms": "10"})
        assert status == 504 and b"cannot be met" in body
        s = srv.stats.summary()
        assert s["requests"] == 0 and s["deadline_expired"] == 1
    finally:
        srv.request_drain()
        assert srv.join(timeout=120) == 0


def test_overload_sheds_429_and_is_fully_accounted(engine):
    srv = _start(engine, max_batch=2, max_wait_ms=5, max_queue=8, admit_watermark=2)
    try:
        payloads = [_png(photo(28 + i, 30, i)) for i in range(4)]
        rep = run_load(srv.url, payloads, concurrency=8, total=48)
    finally:
        srv.request_drain()
        assert srv.join(timeout=120) == 0
    summary = srv.stats.summary()
    assert rep["errors"] == 0 and rep["shed"] > 0 and rep["ok"] > 0
    assert rep["ok"] + rep["shed"] + rep["deadline_expired"] + rep["rejected"] == rep["sent"]
    assert summary["requests"] == rep["ok"]
    assert summary["shed_count"] == rep["shed"]
    assert summary["queue_depth"] == 0


def test_reject_admit_fault_sheds_deterministically(server):
    port = server.bound_port
    payload = _png(photo(30, 30, 5))
    faults.install(faults.FaultPlan.parse("reject_admit@2"))
    statuses = [_request(port, "POST", "/enhance", body=payload) for _ in range(3)]
    faults.clear()
    assert [s for s, _, _ in statuses] == [200, 429, 200]
    assert statuses[1][1].get("Retry-After") == "1"


def test_slo_loop_lag_and_png_level_options(engine):
    """--slo grades /healthz and adds the slo block; --obs-loop-lag turns
    the loop_lag block on; --png-level changes the bytes, not the pixels."""
    srv = _start(engine, max_wait_ms=5, slo="p99_ms<=100000,error_rate<=0.5",
                 obs_loop_lag=True, png_level=1, encode_threads=1)
    try:
        port = srv.bound_port
        bgr = photo(30, 30, 12)
        status, _, body = _request(port, "POST", "/enhance", body=_png(bgr))
        assert status == 200
        np.testing.assert_array_equal(_response_rgb(body), _expected_offline(engine, bgr[:, :, ::-1]))
        ok, default = cv2.imencode(".png", cv2.cvtColor(_response_rgb(body), cv2.COLOR_RGB2BGR))
        assert ok and body != default.tobytes()  # level 1, not cv2's default
        health = json.loads(_request(port, "GET", "/healthz")[2])
        assert health["status"] == "ok" and health["slo"]["grade"] == "ok"
        stats = json.loads(_request(port, "GET", "/stats")[2])
        assert stats["loop_lag"]["enabled"] is True and stats["loop_lag"]["callbacks"] > 0
        assert stats["slo"] is not None and stats["config"]["png_level"] == 1
        assert b"waternet_loop_lag" in _request(port, "GET", "/metrics")[2]
    finally:
        srv.request_drain()
        assert srv.join(timeout=120) == 0
    with pytest.raises(ValueError, match="png_level"):
        ServingServer(engine, BucketLadder([BUCKET]), png_level=10)


@pytest.mark.loop_stall_ok
def test_gateway_hang_wedges_the_loop_until_released(engine):
    """gateway_hang@1 blocks the server's event loop on the first /enhance
    arrival: /healthz stops answering until the plan is cleared, then the
    wedged request is answered and the server drains cleanly."""
    srv = _start(engine, max_wait_ms=5)
    try:
        port = srv.bound_port
        faults.install(faults.FaultPlan.parse("gateway_hang@1"))
        result = {}
        poster = threading.Thread(
            target=lambda: result.setdefault("r", _request(port, "POST", "/enhance", body=_png(photo(20, 20, 13)))))
        poster.start()
        time.sleep(0.2)
        with pytest.raises(OSError):  # socket.timeout: the loop is wedged
            _request(port, "GET", "/healthz", timeout=1.0)
        faults.clear()  # releases the wedged loop
        poster.join(60)
        assert not poster.is_alive() and result["r"][0] == 200
        assert _request(port, "GET", "/healthz")[0] == 200
    finally:
        faults.clear()
        srv.request_drain()
        assert srv.join(timeout=120) == 0


def test_gateway_crash_kills_the_server_process():
    """gateway_crash@1 (WATERNET_FAULTS): the first /enhance arrival
    SIGKILLs the serving process, no answer sent."""
    env = dict(os.environ, PYTHONUNBUFFERED="1", WATERNET_FAULTS="gateway_crash@1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "waternet_tpu_torch.serving.server", "--device", "cpu", "--port", "0",
         "--weights", TEACHER, "--serve-buckets", "32", "--max-batch", "2"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        port = None
        deadline = time.monotonic() + 120
        while port is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            assert line, "the server exited before listening"
            if "ready (" in line:
                port = srv_port
            elif "listening on" in line:
                srv_port = int(line.strip().rsplit(":", 1)[1])
        assert port
        with pytest.raises((ConnectionError, http.client.HTTPException)):
            _request(port, "POST", "/enhance", body=_png(photo(20, 20, 14)), timeout=30)
        assert proc.wait(timeout=60) == -signal.SIGKILL
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()


def test_batcher_max_queue_and_deadline_clamp(engine):
    img = photo(30, 30, 6)
    b = DynamicBatcher(engine, BucketLadder([BUCKET]), max_batch=MAX_BATCH, max_wait_ms=10_000,
                       max_queue=2)
    try:
        f1, f2 = b.submit(img), b.submit(img)
        with pytest.raises(QueueFull, match="max_queue=2"):
            b.submit(img)
        assert b.queue_depth() == 2 and b.stats.summary()["shed_count"] == 1
        b.drain()
        assert f1.result(timeout=60).shape == img.shape and f2.result(timeout=60).shape == img.shape
        with pytest.raises(DeadlineExpired):
            b.submit(img, deadline=time.perf_counter() - 0.01)
        t0 = time.perf_counter()
        fut = b.submit(img, deadline=time.perf_counter() + 0.02)
        with pytest.raises(DeadlineExpired):
            fut.result(timeout=30)
        assert time.perf_counter() - t0 < 5.0, "the deadline did not clamp the 10 s window"
        assert b.stats.summary()["deadline_expired"] == 2
    finally:
        b.close()


def test_drain_completes_inflight_byte_identical(engine):
    """request_drain() with admitted requests in flight: late arrivals get
    503 + Connection: close, every admitted request completes equal to
    the offline output, and the server exits 0."""
    srv = _start(engine, max_wait_ms=5000, grace_sec=60)
    port = srv.bound_port
    imgs = [photo(28 + i, 30, 40 + i) for i in range(3)]
    results = {}
    os.environ["WATERNET_FAULT_SLOW_SEC"] = "1.0"
    faults.install(faults.FaultPlan.parse("slow_replica@1"))
    try:
        posters = [threading.Thread(
            target=lambda i=i: results.__setitem__(i, _request(port, "POST", "/enhance", body=_png(imgs[i]))))
            for i in range(3)]
        for t in posters:
            t.start()
        deadline = time.monotonic() + 60
        while srv.batcher.queue_depth() < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv.batcher.queue_depth() == 3
        srv.request_drain()
        while not srv.draining.is_set() and time.monotonic() < deadline:
            time.sleep(0.01)
        status, headers, _ = _request(port, "POST", "/enhance", body=_png(imgs[0]), timeout=30)
        assert status == 503 and headers.get("Connection") == "close"
        for t in posters:
            t.join(60)
            assert not t.is_alive()
        assert srv.join(timeout=120) == 0
    finally:
        os.environ.pop("WATERNET_FAULT_SLOW_SEC", None)
        faults.clear()
    for i, img in enumerate(imgs):
        status, _, body = results[i]
        assert status == 200
        np.testing.assert_array_equal(_response_rgb(body), _expected_offline(engine, img[:, :, ::-1]))
    s = srv.stats.summary()
    assert s["requests"] == 3 and s["queue_depth"] == 0


def test_reload_invariance_rollback_and_no_cold_dispatch(tmp_path):
    eng = InferenceEngine(weights=TEACHER, device="cpu")
    srv = _start(eng, max_wait_ms=5, max_queue=16, response_cache=4)
    try:
        port = srv.bound_port
        payload = _png(photo(30, 30, 7))
        before = _request(port, "POST", "/enhance", body=payload)
        assert before[0] == 200 and before[1]["X-Cache"] == "miss"
        assert _request(port, "POST", "/enhance", body=payload)[1]["X-Cache"] == "hit"

        status, _, body = _request(port, "POST", "/admin/reload",
                                   body=json.dumps({"weights": TEACHER}).encode())
        assert status == 200 and json.loads(body)["reloaded"] is True
        after = _request(port, "POST", "/enhance", body=payload)
        assert after[1]["X-Cache"] == "miss"  # the reload invalidated the cache
        assert after[2] == before[2], "an identical-weights reload changed bytes"

        bad = dict(init_state_dict(0))
        bad["cmg.conv1.weight"] = torch.zeros(4, 4)
        bad_path = tmp_path / "bad.pt"
        torch.save(bad, bad_path)
        status, _, body = _request(port, "POST", "/admin/reload",
                                   body=json.dumps({"weights": str(bad_path)}).encode())
        assert status == 409
        err = json.loads(body)
        assert err["reloaded"] is False and "mismatch" in err["error"] and "cmg.conv1.weight" in err["error"]
        still = _request(port, "POST", "/enhance", body=_png(photo(30, 30, 8)))
        assert still[0] == 200
        np.testing.assert_array_equal(_response_rgb(still[2]), _expected_offline(eng, photo(30, 30, 8)[:, :, ::-1]))
        status, _, _ = _request(port, "POST", "/admin/reload",
                                body=json.dumps({"weights": str(tmp_path / "missing.npz")}).encode())
        assert status == 400
        assert _request(port, "POST", "/admin/reload", body=b"[1]")[0] == 400
        summary = srv.stats.summary()
    finally:
        srv.request_drain()
        assert srv.join(timeout=120) == 0
    assert summary["compiles"] == 1 and summary["fallback_native_shapes"] == 0
    assert eng.cold_dispatches == 0


def test_serve_url_matches_local_bucketed_serving(server, tmp_path):
    from waternet_tpu_torch import inference as cli

    src = tmp_path / "imgs"
    src.mkdir()
    for i, (h, w) in enumerate([(30, 30), (28, 32), (32, 32)]):
        cv2.imwrite(str(src / f"im{i}.png"), photo(h, w, 50 + i))
    cli.main(["--source", str(src), "--weights", TEACHER, "--device", "cpu",
              "--batch-size", str(MAX_BATCH), "--serve-buckets", "32", "--serve-replicas", "1",
              "--output-root", str(tmp_path / "local")])
    cli.main(["--source", str(src), "--serve-url", server.url, "--output-root", str(tmp_path / "remote")])
    for p in sorted(src.glob("*.png")):
        assert (tmp_path / "local" / "0" / p.name).read_bytes() == (tmp_path / "remote" / "0" / p.name).read_bytes()
    (src / "clip.mp4").write_bytes(b"\x00")
    with pytest.raises(SystemExit, match="image sources only"):
        cli.main(["--source", str(src), "--serve-url", server.url, "--output-root", str(tmp_path / "r2")])


def test_server_and_loadgen_clis_end_to_end(tmp_path):
    """``python -m waternet_tpu_torch.serving.server --device cpu --port 0``
    warms, answers ``python -m waternet_tpu_torch.serving.loadgen``, and on
    SIGTERM drains, flushes its stats and exits 0."""
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "waternet_tpu_torch.serving.server", "--device", "cpu", "--port", "0",
         "--weights", TEACHER, "--serve-buckets", "32", "--max-batch", "2"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    lines = []
    pump = threading.Thread(target=lambda: lines.extend(ln.rstrip() for ln in proc.stdout), daemon=True)
    pump.start()
    try:
        deadline = time.monotonic() + 120
        port = None
        while time.monotonic() < deadline and not any("ready (" in ln for ln in lines):
            port = port or next((int(ln.rsplit(":", 1)[1]) for ln in lines if "listening on" in ln), None)
            assert proc.poll() is None, lines
            time.sleep(0.05)
        port = port or next(int(ln.rsplit(":", 1)[1]) for ln in lines if "listening on" in ln)
        load = subprocess.run(
            [sys.executable, "-m", "waternet_tpu_torch.serving.loadgen", "--url", f"http://127.0.0.1:{port}",
             "--synthetic", "24x30", "--requests", "4", "--concurrency", "2"],
            cwd=REPO, capture_output=True, text=True, timeout=120,
        )
        assert load.returncode == 0, load.stderr
        report = json.loads(load.stdout.strip().splitlines()[-1])
        assert report["ok"] == 4 and report["errors"] == 0
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    pump.join(10)
    flushed = [json.loads(ln) for ln in lines if ln.startswith('{"serving_stats"')]
    assert len(flushed) == 1 and flushed[0]["serving_stats"]["requests"] == 4


@pytest.mark.parametrize("flag,item", [(["--max-streams", "2"], "item 6"),
                                       (["--stream-window", "4"], "item 6"),
                                       (["--stream-reuse-threshold", "1.5"], "item 6"),
                                       (["--stream-max-reuse-run", "3"], "item 6")])
def test_server_flags_of_later_slices_exit_2(flag, item, capsys):
    from waternet_tpu_torch.serving import server

    assert server.main(["--device", "cpu", *flag]) == 2
    assert item in capsys.readouterr().err


def test_server_and_roundtrip_default_to_cuda():
    """Without ``--device cpu`` / ``device="cpu"`` the server's main and the
    codec's roundtrip run on CUDA, and raise on a machine without it."""
    from waternet_tpu_torch.data import codec
    from waternet_tpu_torch.serving import server

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        server.main(["--weights", TEACHER, "--port", "0"])
    u8 = np.zeros((1, 16, 16, 3), np.uint8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        codec.roundtrip("dct8", u8)
    assert codec.roundtrip("raw", u8, device="cpu").shape == u8.shape


def test_bench_serve_http_line_on_the_cpu(monkeypatch, capsys):
    from waternet_tpu_torch import bench

    for k, v in {"WATERNET_BENCH_HW": "32", "WATERNET_BENCH_SERVE_IMAGES": "6",
                 "WATERNET_BENCH_SERVE_BATCH": "2", "WATERNET_BENCH_SERVE_REQUESTS": "12"}.items():
        monkeypatch.setenv(k, v)
    assert bench.main(["--device", "cpu", "--config", "serve_http"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "http_images_per_sec" and line["unit"] == "images/sec"
    assert line["value"] > 0 and line["accounted"] is True
    assert line["p99_ms"] > 0 and line["p99_unloaded_ms"] > 0
    assert 0.0 <= line["shed_rate_at_2x"] <= 1.0
    assert line["compiles"] == len(line["buckets"]) == 3 and line["cold_dispatches"] == 0
    assert line["device_kind"] == "cpu"
