"""The port's fleet router (waternet_tpu_torch/serving/fleet.py) and the
server's side of its worker contract, on the CPU, mirroring
tests/test_fleet.py.

* **Pure units against JAX**: ``HashRing`` maps a seeded set of session
  ids exactly as the JAX ``HashRing`` does, before and after a member
  dies; ``FleetPolicy`` gives the JAX policy's transitions on the same
  burn sequence.
* **The control loop** on a fake clock: sustained page burn browns out
  and scales up, sustained ok restores.
* **Integration over tests/fleet_worker.py** (the JAX package's stub
  worker, unedited): routing, identity stamps, verdict relays, stream
  pinning, per-worker accounting, policy pushes, crash and hang failover;
  the port's router and the JAX router give the same answers through the
  same crash.
* **Real workers**: 2 ``python -m waternet_tpu_torch.serving.server
  --device cpu`` processes at the smallest ladder: ``X-Worker-Id``,
  serve-phase heartbeats, and byte identity across a ``gateway_crash``
  failover.

Every wait has a timeout; every router is drained in ``finally``.
"""

from __future__ import annotations

import http.client
import json
import random
import socket
import struct
import sys
import time
from collections import Counter
from pathlib import Path
from urllib.parse import urlparse

import cv2
import numpy as np
import pytest

from waternet_tpu.serving import fleet as jax_fleet
from waternet_tpu_torch.resilience.heartbeat import read_heartbeat
from waternet_tpu_torch.serving.fleet import (
    FleetPolicy,
    FleetRouter,
    HashRing,
    backoff_sec,
    render_fleet_prometheus,
    worker_id,
)

pytestmark = pytest.mark.usefixtures("locktrace", "looptrace")

REPO = Path(__file__).resolve().parent.parent
STUB = REPO / "tests" / "fleet_worker.py"
TEACHER = str(REPO / "tests" / "fixtures" / "distill" / "teacher.npz")
_FRAME_LEN = struct.Struct("!I")


def transform(payload: bytes) -> bytes:
    """The stub worker's deterministic 'enhancement'."""
    return bytes(255 - b for b in payload)


# ---------------------------------------------------------------------------
# HashRing and FleetPolicy against JAX
# ---------------------------------------------------------------------------


def _session_ids(n=3000, seed=11):
    rng = random.Random(seed)
    return [f"s-{rng.getrandbits(48):012x}" for _ in range(n)] + ["session-a", "cam-0", "lg-x-00001", "s1", "s2"]


@pytest.mark.parametrize("members,dead", [(4, 2), (2, 0), (5, 4)])
def test_ring_maps_like_jax_before_and_after_a_death(members, dead):
    ours, theirs = HashRing(), jax_fleet.HashRing()
    for slot in range(members):
        ours.add(slot)
        theirs.add(slot)
    keys = _session_ids()
    before = {k: ours.lookup(k) for k in keys}
    assert before == {k: theirs.lookup(k) for k in keys}
    ours.remove(dead)
    theirs.remove(dead)
    after = {k: ours.lookup(k) for k in keys}
    assert after == {k: theirs.lookup(k) for k in keys}
    # Only the dead member's sessions moved, and a rejoin restores them.
    assert {k for k in keys if before[k] != after[k]} == {k for k in keys if before[k] == dead}
    ours.add(dead)
    assert {k: ours.lookup(k) for k in keys} == before
    assert sorted(ours.members()) == list(range(members))


def test_ring_spread_pins_and_validation():
    ring = HashRing()
    for slot in range(4):
        ring.add(slot)
    counts = Counter(ring.lookup(f"k{i}") for i in range(10_000))
    assert set(counts) == {0, 1, 2, 3} and all(0.10 <= n / 10_000 <= 0.45 for n in counts.values())
    assert {k: ring.lookup(k) for k in ("session-a", "session-b", "session-c", "cam-0", "cam-1")} == {
        "session-a": 2, "session-b": 0, "session-c": 3, "cam-0": 0, "cam-1": 2}
    assert HashRing().lookup("anything") is None
    with pytest.raises(ValueError):
        HashRing(vnodes=0)


def _burns(seed=5, n=400):
    """A seeded sequence of (time, grade, workers) control ticks."""
    rng = random.Random(seed)
    t, workers, out = 0.0, 2, []
    for _ in range(n):
        t += rng.choice((0.5, 1.0, 5.0, 12.0, 31.0))
        grade = rng.choices(("ok", "warn", "page"), weights=(5, 2, 3))[0]
        workers = max(1, min(5, workers + rng.choice((-1, 0, 0, 1))))
        out.append((t, grade, workers))
    return out


@pytest.mark.parametrize("lo,hi,cooldown", [(2, 4, 30.0), (1, 5, 0.0), (3, 3, 10.0)])
def test_policy_transitions_equal_jax(lo, hi, cooldown):
    ours, theirs = FleetPolicy(lo, hi, cooldown_sec=cooldown), jax_fleet.FleetPolicy(lo, hi, cooldown_sec=cooldown)
    for t, grade, workers in _burns():
        assert ours.step(t, grade, workers) == theirs.step(t, grade, workers), (t, grade, workers)
        assert ours.brownout == theirs.brownout
    for bad in ((3, 2), (0, 2)):
        with pytest.raises(ValueError):
            FleetPolicy(*bad)


def test_policy_page_then_ok_sequence():
    p = FleetPolicy(2, 4, cooldown_sec=30.0)
    assert p.step(0.0, "page", 2) == ["brownout", "scale_up"]
    assert p.step(1.0, "page", 3) == []
    assert p.step(40.0, "page", 3) == ["scale_up"]
    assert p.step(80.0, "page", 4) == []
    assert p.step(120.0, "ok", 4) == ["restore", "scale_down"]
    assert p.brownout is False


def test_backoff_and_worker_id_equal_jax():
    assert [backoff_sec(0.25, 5.0, i) for i in range(8)] == [jax_fleet.backoff_sec(0.25, 5.0, i) for i in range(8)]
    assert worker_id(3, 7) == jax_fleet.worker_id(3, 7) == "w3g7"


# ---------------------------------------------------------------------------
# The SLO closed loop on a fake clock
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t


def _control_router(tmp_path, clock):
    return FleetRouter([sys.executable, "-c", "raise SystemExit(0)"], n_workers=1, max_workers=3,
                       slo="error_rate<=0.05", slo_short_sec=5.0, slo_long_sec=30.0, slo_hold_sec=10.0,
                       scale_cooldown_sec=10.0, heartbeat_root=tmp_path, clock=clock)


def test_sustained_page_burn_triggers_scale_up_and_brownout(tmp_path, monkeypatch):
    clock = FakeClock()
    router = _control_router(tmp_path, clock)
    spawned, pushed = [], []
    monkeypatch.setattr(router, "_spawn_worker", lambda slot, gen: spawned.append((slot, gen)))
    monkeypatch.setattr(router, "_apply_policy", lambda w, wm: pushed.append((w.worker_id, wm)))
    for t in range(5):
        clock.t = float(t)
        for _ in range(8):
            router._windows.observe(500, 100.0)
    clock.t = 5.0
    router._control_tick(clock.t)
    events = {e["event"]: e for e in router.summary()["fleet"]["events"]}
    assert events["scale_up"]["objective"].startswith("error_rate")
    assert events["brownout"]["objective"].startswith("error_rate")
    assert spawned == [(1, 0)] and router._policy.brownout
    clock.t = 6.0
    router._control_tick(clock.t)
    assert spawned == [(1, 0)]


def test_sustained_ok_restores_after_hold(tmp_path, monkeypatch):
    clock = FakeClock()
    router = _control_router(tmp_path, clock)
    monkeypatch.setattr(router, "_spawn_worker", lambda slot, gen: None)
    monkeypatch.setattr(router, "_apply_policy", lambda w, wm: None)
    for t in range(5):
        clock.t = float(t)
        router._windows.observe(500, 100.0)
    clock.t = 5.0
    router._control_tick(clock.t)
    assert router._policy.brownout
    for t in range(6, 70):
        clock.t = float(t)
        router._windows.observe(200, 10.0)
        router._control_tick(clock.t)
        if not router._policy.brownout:
            break
    assert not router._policy.brownout, "ok state never restored the baseline policy"
    assert "restore" in [e["event"] for e in router.summary()["fleet"]["events"]]
    assert router.summary()["slo"]["state"] == "ok"


# ---------------------------------------------------------------------------
# Integration over the stub worker
# ---------------------------------------------------------------------------


def _start_fleet(cls=FleetRouter, cmd=None, **overrides):
    kw = dict(n_workers=2, poll_sec=0.05, health_poll_sec=0.1, heartbeat_sec=0.1, late_sec=1.0, hang_sec=2.0,
              startup_grace_sec=60.0, drain_grace_sec=1.0, grace_sec=10.0, backoff_base_sec=0.05,
              backoff_cap_sec=0.2, port=0)
    kw.update(overrides)
    router = cls(cmd or [sys.executable, str(STUB)], **kw)
    router.start_background()
    try:
        router.wait_ready(timeout=120.0)
    except BaseException:
        router.request_drain()
        router.join()
        raise
    return router


def _request(url, method, path, body=b"", headers=None, timeout=60.0):
    u = urlparse(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}, data
    finally:
        conn.close()


def _get_stats(url):
    status, _, body = _request(url, "GET", "/stats")
    assert status == 200
    return json.loads(body)


def _wait(cond, timeout=60.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def test_fleet_end_to_end(tmp_path):
    router = _start_fleet(heartbeat_root=tmp_path)
    try:
        url = router.url
        status, headers, body = _request(url, "POST", "/enhance", b"hello fleet", {"X-Request-Id": "e2e-1"})
        assert status == 200 and body == transform(b"hello fleet")
        assert headers["x-request-id"] == "e2e-1"
        assert headers["x-worker-id"] in (worker_id(0, 0), worker_id(1, 0))
        # Verdicts relay Retry-After and the ids verbatim.
        status, headers, _ = _request(url, "POST", "/enhance", b"SHED", {"X-Request-Id": "e2e-shed"})
        assert status == 429 and headers["retry-after"] == "7" and headers["x-request-id"] == "e2e-shed"
        status, headers, _ = _request(url, "GET", "/nope", headers={"X-Request-Id": "e2e-404"})
        assert status == 404 and headers["x-request-id"] == "e2e-404"
        # Per-worker accounting reconciles the client with the router.
        from waternet_tpu_torch.serving import loadgen

        before = _get_stats(url)["fleet"]["per_worker"]
        report = loadgen.run_load(url, [b"abc", b"defgh"], concurrency=3, total=12, per_worker=True,
                                  collect_ledger=True)
        assert report["ok"] == 12
        after = _get_stats(url)["fleet"]["per_worker"]
        for wid, counts in report["per_worker"].items():
            assert wid != "unattributed"
            assert after[wid]["ok"] - before.get(wid, {}).get("ok", 0) == counts["ok"]
        assert all(e["worker"] in report["per_worker"] for e in report["ledger"])
        status, _, body = _request(url, "GET", "/healthz")
        health = json.loads(body)
        assert status == 200 and health["status"] == "ok"
        assert set(health["workers"]) == {worker_id(0, 0), worker_id(1, 0)}
        stats = _get_stats(url)
        assert stats["fleet"]["ready"] == 2 and stats["fleet"]["routed"]["enhance"] >= 14
        status, _, body = _request(url, "GET", "/metrics")
        assert status == 200 and "waternet_fleet_workers 2" in body.decode()
        assert render_fleet_prometheus(stats) == jax_fleet.render_fleet_prometheus(stats)
        # Stream sessions pin by consistent hash on the session id.
        for session, slot in (("s1", 0), ("s2", 1)):
            u = urlparse(url)
            sock = socket.create_connection((u.hostname, u.port), timeout=30.0)
            try:
                sock.sendall(f"POST /stream HTTP/1.1\r\nHost: x\r\nX-Request-Id: {session}\r\n\r\n".encode())
                f = sock.makefile("rb")
                assert b"200" in f.readline()
                shead = {}
                while True:
                    line = f.readline()
                    if not line or line in (b"\r\n", b"\n"):
                        break
                    name, _, value = line.decode().partition(":")
                    shead[name.strip().lower()] = value.strip()
                assert shead["x-worker-id"] == worker_id(slot, 0) and shead["x-request-id"] == session
                for frame in (b"frame-one", b"frame-two!"):
                    sock.sendall(_FRAME_LEN.pack(len(frame)) + frame)
                    (n,) = _FRAME_LEN.unpack(f.read(_FRAME_LEN.size))
                    assert f.read(n) == transform(frame)
                sock.sendall(_FRAME_LEN.pack(0))
                assert _FRAME_LEN.unpack(f.read(_FRAME_LEN.size)) == (0,)
            finally:
                sock.close()
        assert _get_stats(url)["fleet"]["routed"]["stream"] == 2
        # Brown-out push and restore through /admin/policy.
        w0 = _get_stats(url)["workers"][worker_id(0, 0)]
        router._apply_brownout(0.0, "manual-test")
        _, _, pbody = _request(f"http://127.0.0.1:{w0['port']}", "POST", "/admin/policy", b"{}",
                               {"Content-Type": "application/json"})
        assert json.loads(pbody)["policy"]["downgrade_watermark"] == 1
        router._apply_restore(0.0, "manual-test")
        _, _, pbody = _request(f"http://127.0.0.1:{w0['port']}", "POST", "/admin/policy", b"{}",
                               {"Content-Type": "application/json"})
        assert json.loads(pbody)["policy"]["downgrade_watermark"] == 6
        # Deadline-aware routing refuses an infeasible budget.
        _wait(lambda: all(w.latency_p50_ms for w in router._workers.values()), what="latency gauges")
        status, headers, body = _request(url, "POST", "/enhance", b"x",
                                         {"X-Request-Id": "e2e-ddl", "X-Deadline-Ms": "0.001"})
        assert status == 504 and headers["x-request-id"] == "e2e-ddl" and b"deadline" in body
    finally:
        router.request_drain()
        rc = router.join()
    assert rc == 0


def _crash_outcome(cls, tmp_path):
    """One crash-failover episode over the stub -> what the client saw."""
    router = _start_fleet(cls, heartbeat_root=tmp_path, worker_faults={(0, 0): "gateway_crash@1"})
    try:
        status, headers, body = _request(router.url, "POST", "/enhance", b"crash me once",
                                         {"X-Request-Id": "failover-1"})
        _wait(lambda: _get_stats(router.url)["fleet"]["ready"] == 2
              and worker_id(0, 1) in _get_stats(router.url)["workers"], what="slot 0 relaunch")
        stats = _get_stats(router.url)
        after = _request(router.url, "POST", "/enhance", b"post-recovery", {"X-Request-Id": "failover-2"})
        failed = [e["worker"] for e in stats["fleet"]["events"] if e["event"] == "worker_failed"]
        ready = [e for e in stats["fleet"]["events"] if e["event"] == "worker_ready" and "recovery_sec" in e]
        return {
            "answer": (status, headers["x-request-id"], headers["x-worker-id"], body),
            "redispatched": stats["fleet"]["redispatches"] >= 1, "restarts": stats["fleet"]["restarts"],
            "failed": failed, "recovered": bool(ready) and ready[-1]["recovery_sec"] > 0,
            "after": (after[0], after[1]["x-request-id"], after[2]),
        }
    finally:
        router.request_drain()
        assert router.join() == 0


def test_crash_failover_preserves_bytes_and_request_id_like_jax(tmp_path):
    """gateway_crash@1 SIGKILLs slot 0 on its first /enhance: the client
    still gets the byte-exact answer with its request id from the
    survivor, slot 0 comes back as generation 1, and the JAX router
    gives the same outcome over the same stub."""
    ours = _crash_outcome(FleetRouter, tmp_path / "port")
    assert ours["answer"] == (200, "failover-1", worker_id(1, 0), transform(b"crash me once"))
    assert ours["redispatched"] and ours["restarts"] >= 1 and ours["recovered"]
    assert worker_id(0, 0) in ours["failed"]
    assert ours["after"] == (200, "failover-2", transform(b"post-recovery"))
    assert ours == _crash_outcome(jax_fleet.FleetRouter, tmp_path / "jax")


def test_hang_failover_and_relaunch(tmp_path):
    """gateway_hang@1 wedges slot 0's loop: the per-attempt proxy timeout
    re-dispatches the in-flight request; the heartbeat age then declares
    the hang and relaunches the slot."""
    router = _start_fleet(heartbeat_root=tmp_path, worker_faults={(0, 0): "gateway_hang@1"}, proxy_timeout_sec=0.5,
                          hang_sec=1.5)
    try:
        t0 = time.monotonic()
        status, headers, body = _request(router.url, "POST", "/enhance", b"hang in there", {"X-Request-Id": "hung-1"})
        assert status == 200 and body == transform(b"hang in there")
        assert headers["x-request-id"] == "hung-1" and headers["x-worker-id"] == worker_id(1, 0)
        assert time.monotonic() - t0 < 10.0
        _wait(lambda: worker_id(0, 1) in _get_stats(router.url)["workers"]
              and _get_stats(router.url)["fleet"]["ready"] == 2, what="hung worker relaunch")
        hung = [e for e in _get_stats(router.url)["fleet"]["events"]
                if e["event"] == "worker_failed" and e["worker"] == worker_id(0, 0)]
        assert hung and hung[0]["reason"] == "heartbeat"
    finally:
        router.request_drain()
        rc = router.join()
    assert rc == 0


# ---------------------------------------------------------------------------
# Real port workers
# ---------------------------------------------------------------------------


def _png(rgb):
    ok, buf = cv2.imencode(".png", rgb[:, :, ::-1])
    assert ok
    return buf.tobytes()


def test_real_port_workers_stamp_beat_and_fail_over_byte_identically(tmp_path):
    """2 ``python -m waternet_tpu_torch.serving.server --device cpu``
    workers (one 32x32 bucket, 2 slots) behind the port's router, slot 0
    with gateway_crash@1: serve-phase heartbeats, ``X-Worker-Id`` on the
    answers and on a stream head, and the failover answer byte-identical
    to the relaunched worker's and the survivor's for the same upload."""
    cmd = [sys.executable, "-m", "waternet_tpu_torch.serving.server", "--device", "cpu", "--weights", TEACHER,
           "--serve-buckets", "32", "--max-batch", "2", "--max-wait-ms", "5"]
    router = _start_fleet(cmd=cmd, heartbeat_root=tmp_path, worker_faults={(0, 0): "gateway_crash@1"},
                          heartbeat_sec=0.2, late_sec=10.0, hang_sec=30.0, drain_grace_sec=10.0, grace_sec=30.0,
                          startup_grace_sec=120.0)
    rgb = np.asarray(np.random.default_rng(0).integers(0, 256, (30, 28, 3)), dtype=np.uint8)
    try:
        with router._lock:
            workers = list(router._workers.values())

        def serving():
            beats = [read_heartbeat(w.hb_file) for w in workers]
            return all(b is not None and b["phase"] == "serve" for b in beats)

        # Ready on /healthz first; the loop's next beat then says "serve".
        _wait(serving, timeout=30.0, what="serve-phase heartbeats")
        status, headers, body = _request(router.url, "POST", "/enhance", _png(rgb), {"X-Request-Id": "real-1"})
        assert (status, headers["x-request-id"], headers["x-worker-id"]) == (200, "real-1", worker_id(1, 0))
        _wait(lambda: _get_stats(router.url)["fleet"]["ready"] == 2
              and worker_id(0, 1) in _get_stats(router.url)["workers"], timeout=120.0, what="slot 0 relaunch")
        answers = {}
        for i in range(8):
            st, hd, bd = _request(router.url, "POST", "/enhance", _png(rgb), {"X-Request-Id": f"real-{i + 2}"})
            assert st == 200 and hd["x-request-id"] == f"real-{i + 2}"
            answers.setdefault(hd["x-worker-id"], bd)
        assert set(answers) == {worker_id(0, 1), worker_id(1, 0)}
        assert all(bd == body for bd in answers.values())
        u = urlparse(router.url)
        sock = socket.create_connection((u.hostname, u.port), timeout=60.0)
        try:
            sock.sendall(b"POST /stream HTTP/1.1\r\nHost: x\r\nX-Request-Id: s1\r\n\r\n")
            f = sock.makefile("rb")
            assert b"200" in f.readline()
            head = {}
            while True:
                line = f.readline()
                if not line or line in (b"\r\n", b"\n"):
                    break
                name, _, value = line.decode().partition(":")
                head[name.strip().lower()] = value.strip()
            sock.sendall(_FRAME_LEN.pack(0))
            f.read()
        finally:
            sock.close()
        assert head["x-worker-id"] in (worker_id(0, 1), worker_id(1, 0)) and head["x-request-id"] == "s1"
    finally:
        router.request_drain()
        rc = router.join(timeout=120)
    assert rc == 0
