"""Per-request quality tiers in the port (the fast tier): the CAN student's
``StudentEngine``, the tier-routing ``DynamicBatcher`` (``fast_engine``,
``tier_name``, ``downgrade_watermark``), the HTTP front door's ``X-Tier``
routing, ``X-Tier-Allow-Downgrade``/``X-Tier-Served`` and ``POST
/admin/policy``, and the inference CLI's ``--tier fast``, on the CPU.

Bounds: quality answers byte-identical to a tier-less batcher on the same
stream; fast answers byte-identical to ``StudentEngine.enhance_padded`` on
the same canvas; the fast tier within SSIM 0.85 of the quality tier on the
distilled fixture pair (tests/test_tiers.py's bound); the port's fast tier
within one uint8 level of JAX's ``StudentEngine`` (the fp32 forwards differ
by float rounding only, atol 2e-5, which can move a truncation by one).
"""

import http.client
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import cv2

from waternet_tpu.utils.checkpoint import load_weights as jax_load_weights
from waternet_tpu.utils.tensor import ten2arr as jax_ten2arr
from waternet_tpu_torch.inference_engine import InferenceEngine, StudentEngine
from waternet_tpu_torch.models.can import can_receptive_radius
from waternet_tpu_torch.serving import BucketLadder, DynamicBatcher, UnknownTier
from waternet_tpu_torch.serving.server import ServingServer

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from tools.distill_fixture import HW, N_IMAGES, SEED  # noqa: E402

FIXTURES = REPO / "tests" / "fixtures" / "distill"
STUDENT = str(FIXTURES / "student.npz")
TEACHER = str(FIXTURES / "teacher.npz")
BUCKET = (32, 32)
MAX_BATCH = 4

pytestmark = pytest.mark.usefixtures("looptrace")


@pytest.fixture(scope="module")
def quality():
    return InferenceEngine(weights=TEACHER, device="cpu")


@pytest.fixture(scope="module")
def fast():
    return StudentEngine(weights=STUDENT, device="cpu")


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (24 + i, 26, 3), dtype=np.uint8) for i in range(6)]


def _batcher(quality, fast=None, **kw):
    kw.setdefault("max_batch", MAX_BATCH)
    kw.setdefault("max_wait_ms", 20)
    return DynamicBatcher(quality, BucketLadder([BUCKET]), fast_engine=fast, **kw)


def test_quality_answers_byte_identical_to_a_tierless_batcher(quality, fast, images):
    with _batcher(quality) as plain:
        want = plain.map_ordered(images)
    with _batcher(quality, fast) as two:
        got_q = two.map_ordered(images)
        got_f = two.map_ordered(images, tier="fast")
        stats = two.stats.summary()
    for a, b in zip(got_q, want):
        np.testing.assert_array_equal(a, b)
    assert stats["tiers"]["quality"]["requests"] == len(images)
    assert stats["tiers"]["fast"]["requests"] == len(images)
    assert all(a.shape == im.shape for a, im in zip(got_f, images))
    assert two.tiers == ("fast", "quality")


def test_fast_answers_equal_enhance_padded(fast, quality, images):
    with _batcher(quality, fast) as b:
        outs = b.map_ordered(images, tier="fast")
    for im, out in zip(images, outs):
        h, w = im.shape[:2]
        np.testing.assert_array_equal(out, fast.enhance_padded([im], BUCKET, n_slots=MAX_BATCH)[0, :h, :w])


def test_both_tiers_warmed_with_no_cold_dispatch(images):
    quality = InferenceEngine(weights=TEACHER, device="cpu")
    fast = StudentEngine(weights=STUDENT, device="cpu")
    ladder = BucketLadder([(32, 32), (48, 40)])
    with DynamicBatcher(quality, ladder, max_batch=2, max_wait_ms=5, fast_engine=fast) as b:
        warmed = b.stats.summary()["compiles"]
        b.map_ordered(images)
        b.map_ordered(images, tier="fast")
        stats = b.stats.summary()
    assert warmed == 2 * len(ladder) == stats["compiles"]  # tiers x len(ladder) x replicas
    assert quality.cold_dispatches == 0 and fast.cold_dispatches == 0


def test_fast_oversize_fallback_uses_the_student(quality, fast):
    big = np.random.default_rng(3).integers(0, 256, (40, 45, 3), dtype=np.uint8)
    with _batcher(quality, fast) as b:
        (out,) = b.map_ordered([big], tier="fast")
        stats = b.stats.summary()
    np.testing.assert_array_equal(out, fast.enhance(big[None])[0])
    assert stats["fallback_native_shapes"] == 1 and stats["tiers"]["fast"]["requests"] == 1


def test_fast_tier_interior_equals_native_forward(fast):
    """Beyond the student's receptive radius from the pad seam, a bucketed
    answer equals the native-shape forward bit for bit."""
    r = can_receptive_radius(fast.depth)
    im = np.random.default_rng(4).integers(0, 256, (70, 75, 3), dtype=np.uint8)
    out = fast.enhance_padded([im], (96, 96), n_slots=2)[0, :70, :75]
    native = fast.enhance(im[None])[0]
    np.testing.assert_array_equal(out[: 70 - r, : 75 - r], native[: 70 - r, : 75 - r])


def test_fast_tier_approximates_quality_on_the_fixture_pair():
    """The distilled fixture pair through both tiers of one batcher, at the
    native shape (no padding): mean SSIM >= 0.85 (tests/test_tiers.py)."""
    from waternet_tpu_torch.data.synthetic import SyntheticPairs
    from waternet_tpu_torch.training.metrics import ssim as ssim_fn

    data = SyntheticPairs(N_IMAGES, HW, HW, seed=SEED)
    frames = [data.load_pair(i)[0] for i in range(N_IMAGES)]
    with DynamicBatcher(InferenceEngine(weights=TEACHER, device="cpu"), BucketLadder([(HW, HW)]),
                        max_batch=4, max_wait_ms=5, fast_engine=StudentEngine(weights=STUDENT, device="cpu")) as b:
        outs_q = b.map_ordered(frames)
        outs_f = b.map_ordered(frames, tier="fast")

    def as_t(a):
        return torch.from_numpy(a[None]).to(torch.float32) / 255.0

    ssims = [float(ssim_fn(as_t(f), as_t(q), data_range=1.0)) for f, q in zip(outs_f, outs_q)]
    assert float(np.mean(ssims)) >= 0.85, ssims


def test_unknown_and_unconfigured_tiers_raise(quality, fast):
    with _batcher(quality) as b:
        with pytest.raises(UnknownTier, match="not configured.*--student-weights"):
            b.submit(np.zeros((8, 8, 3), np.uint8), tier="fast")
        with pytest.raises(UnknownTier, match="unknown tier"):
            b.submit(np.zeros((8, 8, 3), np.uint8), tier="turbo")
    with pytest.raises(ValueError, match="tier_name"):
        DynamicBatcher(quality, BucketLadder([BUCKET]), tier_name="turbo")
    with pytest.raises(ValueError, match="primary engine IS the quality tier"):
        DynamicBatcher(quality, BucketLadder([BUCKET]), tier_name="fast", fast_engine=fast)
    with pytest.raises(ValueError, match="downgrade_watermark must be >= 1"):
        DynamicBatcher(quality, BucketLadder([BUCKET]), downgrade_watermark=0)


def test_student_alone_as_the_fast_primary(fast, images):
    with DynamicBatcher(fast, BucketLadder([BUCKET]), max_batch=2, tier_name="fast") as b:
        outs = b.map_ordered(images, tier="fast")
        with pytest.raises(UnknownTier):
            b.submit(images[0], tier="quality")
        stats = b.stats.summary()
    assert stats["tiers"] == {"fast": {"requests": len(images), "batches": stats["batches"]}}
    assert all(o.shape == im.shape for o, im in zip(outs, images))


def test_downgrade_only_for_opted_in_quality_requests(quality, fast, images):
    with _batcher(quality, fast, downgrade_watermark=1, max_wait_ms=200) as b:
        first = b.submit(images[0])  # the quality backlog is now 1
        opted = b.submit(images[1], allow_downgrade=True)
        plain = b.submit(images[2])
        b.drain()
        outs = [f.result(timeout=60) for f in (first, opted, plain)]
        stats = b.stats.summary()
    assert (first.tier, opted.tier, plain.tier) == ("quality", "fast", "quality")
    assert stats["downgraded"] == 1
    h, w = images[1].shape[:2]
    np.testing.assert_array_equal(outs[1], fast.enhance_padded([images[1]], BUCKET, n_slots=MAX_BATCH)[0, :h, :w])


def test_student_engine_refuses_missing_and_waternet_weights():
    with pytest.raises(FileNotFoundError, match="explicit student weights"):
        StudentEngine(device="cpu")
    with pytest.raises(ValueError, match="quality-tier WaterNet weights"):
        StudentEngine(weights=TEACHER, device="cpu")
    with pytest.raises(ValueError, match="empty batch"):
        StudentEngine(weights=STUDENT, device="cpu").enhance_async(np.zeros((0, 8, 8, 3), np.uint8))


def test_port_fast_tier_within_one_level_of_jax_student_engine():
    """The port's StudentEngine against JAX's on the same frames and the
    same fixture student, natively and through a bucket canvas."""
    from waternet_tpu.inference_engine import StudentEngine as JaxStudentEngine

    frames = np.random.default_rng(5).integers(0, 256, (2, 37, 53, 3), dtype=np.uint8)
    jax_eng = JaxStudentEngine(params=jax_load_weights(STUDENT))
    port = StudentEngine(weights=STUDENT, device="cpu")
    for got, want in (
        (port.enhance(frames), np.asarray(jax_eng.enhance(frames))),
        (port.enhance_padded(list(frames), (48, 64), n_slots=2),
         jax_ten2arr(jax_eng.enhance_padded_async(list(frames), (48, 64), n_slots=2))),
    ):
        d = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert got.shape == want.shape and d.max() <= 1, d.max()


def test_student_engine_bf16_close_to_fp32():
    frames = np.random.default_rng(6).integers(0, 256, (2, 30, 40, 3), dtype=np.uint8)
    a = StudentEngine(weights=STUDENT, device="cpu").enhance(frames)
    b = StudentEngine(weights=STUDENT, device="cpu", dtype=torch.bfloat16).enhance(frames)
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 12


# ---------------------------------------------------------------------------
# HTTP front door
# ---------------------------------------------------------------------------


def _request(port, method, path, body=None, headers=None, timeout=60.0):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _png(rgb):
    ok, buf = cv2.imencode(".png", cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
    assert ok
    return buf.tobytes()


def _rgb(body):
    return cv2.cvtColor(cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


@pytest.fixture
def two_tier_server(quality, fast):
    srv = ServingServer(quality, BucketLadder([BUCKET]), max_batch=MAX_BATCH, max_wait_ms=30, max_queue=64,
                        fast_engine=fast)
    srv.start_background()
    srv.wait_ready(timeout=120)
    yield srv
    srv.request_drain()
    assert srv.join(timeout=120) == 0


def test_server_routes_x_tier_and_answers_byte_equal(two_tier_server, quality, fast, images):
    port = two_tier_server.bound_port
    im = images[2]
    h, w = im.shape[:2]
    status, headers, body = _request(port, "POST", "/enhance", body=_png(im), headers={"X-Tier": "fast"})
    assert status == 200 and headers["X-Tier-Served"] == "fast"
    np.testing.assert_array_equal(_rgb(body), fast.enhance_padded([im], BUCKET, n_slots=MAX_BATCH)[0, :h, :w])
    status, headers, body = _request(port, "POST", "/enhance", body=_png(im))
    assert status == 200 and headers["X-Tier-Served"] == "quality"
    np.testing.assert_array_equal(_rgb(body), quality.enhance_padded([im], BUCKET, n_slots=MAX_BATCH)[0, :h, :w])
    status, _, body = _request(port, "POST", "/enhance", body=_png(im), headers={"X-Tier": "turbo"})
    assert status == 400 and b"unknown tier" in body
    status, _, body = _request(port, "GET", "/healthz")
    assert status == 200 and json.loads(body)["replicas"] == {"fast": {"0": "healthy"}, "quality": {"0": "healthy"}}
    stats = json.loads(_request(port, "GET", "/stats")[2])
    assert stats["compiles"] == 2 and stats["tiers"]["fast"]["requests"] == 1


def test_server_without_student_answers_400_fast_tier_not_configured(quality, images):
    srv = ServingServer(quality, BucketLadder([BUCKET]), max_batch=MAX_BATCH, max_queue=64)
    srv.start_background()
    srv.wait_ready(timeout=120)
    try:
        status, _, body = _request(srv.bound_port, "POST", "/enhance", body=_png(images[0]),
                                   headers={"X-Tier": "fast"})
        assert status == 400 and json.loads(body)["error"].startswith("fast tier not configured")
    finally:
        srv.request_drain()
        assert srv.join(timeout=120) == 0


def test_admin_policy_downgrades_opted_in_requests(two_tier_server, fast, images):
    port = two_tier_server.bound_port
    status, _, body = _request(port, "POST", "/admin/policy", body=json.dumps({"downgrade_watermark": 1}).encode())
    assert status == 200 and json.loads(body)["policy"]["downgrade_watermark"] == 1
    assert two_tier_server.batcher.downgrade_watermark == 1
    for bad in (b'{"downgrade_watermark": 0}', b'{"downgrade_watermark": true}', b"[1]", b"nope"):
        assert _request(port, "POST", "/admin/policy", body=bad)[0] == 400
    assert _request(port, "GET", "/admin/policy")[0] == 405
    # Hold a quality request in the batcher so the backlog sits at 1, then
    # an opted-in quality request is served by the fast tier.
    held = two_tier_server.batcher.submit(images[0])
    im = images[3]
    h, w = im.shape[:2]
    status, headers, body = _request(port, "POST", "/enhance", body=_png(im),
                                     headers={"X-Tier-Allow-Downgrade": "1"})
    assert status == 200 and headers["X-Tier-Served"] == "fast"
    np.testing.assert_array_equal(_rgb(body), fast.enhance_padded([im], BUCKET, n_slots=MAX_BATCH)[0, :h, :w])
    held.result(timeout=60)
    assert json.loads(_request(port, "GET", "/stats")[2])["downgraded"] == 1
    status, _, body = _request(port, "POST", "/admin/policy", body=b'{"downgrade_watermark": null}')
    assert status == 200 and json.loads(body)["policy"]["downgrade_watermark"] is None


def test_server_cli_tier_flag_rules(capsys):
    from waternet_tpu_torch.serving import server

    assert server.main(["--device", "cpu", "--student-quantize"]) == 2
    assert "--student-quantize needs --student-weights" in capsys.readouterr().err
    assert server.main(["--device", "cpu", "--downgrade-watermark", "4"]) == 2
    assert "--downgrade-watermark needs --student-weights" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# The inference CLI's --tier fast
# ---------------------------------------------------------------------------


def test_inference_cli_tier_fast_writes_the_student_answers(tmp_path, images):
    from waternet_tpu_torch import inference

    src = tmp_path / "src"
    src.mkdir()
    for i, im in enumerate(images[:3]):
        cv2.imwrite(str(src / f"{i}.png"), cv2.cvtColor(im, cv2.COLOR_RGB2BGR))
    inference.main(["--source", str(src), "--tier", "fast", "--student-weights", STUDENT, "--device", "cpu",
                    "--exact-shapes", "--batch-size", "1", "--output-root", str(tmp_path / "out"), "--name", "f"])
    eng = StudentEngine(weights=STUDENT, device="cpu")
    for i, im in enumerate(images[:3]):
        got = cv2.cvtColor(cv2.imread(str(tmp_path / "out" / "f" / f"{i}.png")), cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(got, eng.enhance(im[None])[0])


@pytest.mark.parametrize("args,needle", [
    (["--allow-downgrade"], "--serve-url"),
    (["--tier", "fast", "--device-preprocess"], "incompatible with --device-preprocess"),
])
def test_inference_cli_refuses_tier_flag_conflicts(args, needle, tmp_path, capsys):
    from waternet_tpu_torch import inference

    with pytest.raises(SystemExit) as exc:
        inference.main(["--source", str(tmp_path), "--device", "cpu", *args])
    assert exc.value.code == 2 and needle in capsys.readouterr().err


def test_thin_client_forwards_the_tier(two_tier_server, fast, images, tmp_path):
    """``inference --serve-url --tier fast`` posts ``X-Tier: fast``; the
    files it writes are the student's answers, byte for byte."""
    from waternet_tpu_torch import inference

    src = tmp_path / "src"
    src.mkdir()
    for i, im in enumerate(images[:3]):
        cv2.imwrite(str(src / f"{i}.png"), cv2.cvtColor(im, cv2.COLOR_RGB2BGR))
    inference.main(["--source", str(src), "--serve-url", two_tier_server.url, "--tier", "fast",
                    "--output-root", str(tmp_path / "out"), "--name", "r"])
    for i, im in enumerate(images[:3]):
        h, w = im.shape[:2]
        got = cv2.cvtColor(cv2.imread(str(tmp_path / "out" / "r" / f"{i}.png")), cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(got, fast.enhance_padded([im], BUCKET, n_slots=MAX_BATCH)[0, :h, :w])
    assert json.loads(_request(two_tier_server.bound_port, "GET", "/stats")[2])["tiers"]["fast"]["requests"] == 3
