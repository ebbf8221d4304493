"""The port's shape-bucketed serving engine (waternet_tpu_torch/serving/),
on the CPU: bucketing against the JAX package, the exactness pins, the
warmed-shape discipline, the replica pool and its fault isolation, the
inference CLI's bucketed default, and the bench's ``serve`` line.

Bounds:

* bucketing (``pad_to_bucket``, ``derive_buckets``, ``RECEPTIVE_RADIUS``)
  equals the JAX package's exactly;
* output pixels farther than ``RECEPTIVE_RADIUS`` (13) from the pad seam
  equal the port's native-shape forward bit for bit (oneDNN on the CPU),
  in both preprocess modes; the seam band holds ``BORDER_PSNR_FLOOR_DB``;
* a request's output is byte-identical whatever its batchmates, its
  replica, or a re-dispatch after ``replica_crash@K``/``nan_output@K``:
  every comparison is of one batch shape with itself (the batch is always
  padded to the warmed slot count);
* ``compiles == len(ladder) x replicas`` with zero cold dispatches (the
  port's counterpart of the JAX package's compile sentinel);
* against JAX's ``DynamicBatcher`` on ``teacher.npz``: within one level
  on under 1% of values (the engines' bound, tests/test_torch_engine.py:
  the forwards differ by float rounding, and the device path's CLAHE
  blend and LAB inverse round differently under XLA's jit).
"""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import cv2

from waternet_tpu.inference_engine import InferenceEngine as JaxEngine
from waternet_tpu.resilience import faults as jax_faults
from waternet_tpu.serving import DynamicBatcher as JaxBatcher
from waternet_tpu.serving import bucketing as jax_bucketing
from waternet_tpu_torch.inference_engine import InferenceEngine
from waternet_tpu_torch.resilience import faults
from waternet_tpu_torch.serving import (
    RECEPTIVE_RADIUS,
    BucketLadder,
    DynamicBatcher,
    ExactShapeBatcher,
    SupervisionConfig,
    derive_buckets,
    pad_to_bucket,
    resolve_replicas,
)

REPO = Path(__file__).resolve().parent.parent
TEACHER = str(REPO / "tests" / "fixtures" / "distill" / "teacher.npz")
#: The reflect-padded seam band's floor (uint8 PSNR against the native
#: forward), the JAX package's pin.
BORDER_PSNR_FLOOR_DB = 20.0

pytestmark = pytest.mark.usefixtures("locktrace")


def photo(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack(
        [55 + 40 * np.sin(xx / 6 + c) + 30 * np.cos(yy / 5 + 2 * c) + 45 * c for c in range(3)],
        axis=-1,
    )
    return np.clip(base + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)


#: Eight images over six shapes, covered by a 2-bucket ladder.
MIXED_SHAPES = [(40, 52), (48, 60), (64, 64), (30, 30), (33, 41), (64, 50), (40, 52), (64, 64)]


@pytest.fixture(scope="module")
def mixed_images():
    return [photo(h, w, i) for i, (h, w) in enumerate(MIXED_SHAPES)]


@pytest.fixture(scope="module")
def engines():
    return {dp: InferenceEngine(weights=TEACHER, device_preprocess=dp, device="cpu") for dp in (False, True)}


@pytest.fixture(autouse=True)
def _no_leftover_fault_plan():
    yield
    faults.clear()
    jax_faults.clear()


def _sup(**kw):
    """Test-speed supervision: a quarantine cycle completes in milliseconds."""
    kw.setdefault("scan_interval_sec", 0.005)
    kw.setdefault("rewarm_backoff_sec", 0.01)
    return SupervisionConfig(**kw)


def _wait_for(cond, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def _psnr(a, b):
    mse = float(((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean())
    return 10 * np.log10(255.0**2 / max(mse, 1e-12))


# ---------------------------------------------------------------------------
# Bucketing, against the JAX package
# ---------------------------------------------------------------------------


def test_receptive_radius_is_13_in_both_packages():
    assert RECEPTIVE_RADIUS == jax_bucketing.RECEPTIVE_RADIUS == 13


@pytest.mark.parametrize("shape,bucket", [((30, 40, 3), (32, 48)), ((5, 7, 3), (32, 32)),
                                          ((32, 32, 3), (32, 32)), ((20, 9, 3), (21, 40))])
def test_pad_to_bucket_equals_jax(shape, bucket):
    img = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    np.testing.assert_array_equal(pad_to_bucket(img, *bucket), jax_bucketing.pad_to_bucket(img, *bucket))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_derive_buckets_equals_jax(seed, k):
    rng = np.random.default_rng(seed)
    shapes = [tuple(int(v) for v in rng.integers(16, 300, 2)) for _ in range(25)]
    got = derive_buckets(shapes, max_buckets=k)
    assert got.buckets == jax_bucketing.derive_buckets(shapes, max_buckets=k).buckets
    assert all(got.bucket_for(h, w) is not None for h, w in shapes)


def test_parse_buckets_and_padding_overhead_equal_jax():
    from waternet_tpu_torch.serving.bucketing import padding_overhead, parse_buckets

    spec = "64,32x48,1080x1920"
    assert parse_buckets(spec).buckets == jax_bucketing.parse_buckets(spec).buckets
    shapes = [(30, 30), (60, 50), (2000, 10)]
    assert padding_overhead(shapes, parse_buckets(spec)) == jax_bucketing.padding_overhead(
        shapes, jax_bucketing.parse_buckets(spec))


def test_scan_shapes_reads_headers_and_skips_unreadable(tmp_path):
    from waternet_tpu_torch.serving.bucketing import scan_shapes

    for i, (h, w) in enumerate([(20, 30), (41, 17)]):
        cv2.imwrite(str(tmp_path / f"{i}.png"), photo(h, w, i))
    (tmp_path / "bad.png").write_bytes(b"not an image")
    paths = sorted(tmp_path.glob("*.png"))
    assert scan_shapes(paths) == [(20, 30), (41, 17)] == jax_bucketing.scan_shapes(paths)


# ---------------------------------------------------------------------------
# The engine's padded entry points
# ---------------------------------------------------------------------------


def test_padded_inputs_equal_jax(engines, mixed_images):
    """pad_raw_to_bucket and preprocess_padded build the JAX engine's
    inputs: the same padded canvases and shapes, the same four planes."""
    jax_engine = JaxEngine(weights=TEACHER)
    imgs, bucket = mixed_images[:3], (64, 64)
    canvas, hw = engines[True].pad_raw_to_bucket(imgs, bucket, n_slots=4)
    jcanvas, jhw = jax_engine.pad_raw_to_bucket(imgs, bucket, n_slots=4)
    np.testing.assert_array_equal(canvas, jcanvas)
    np.testing.assert_array_equal(hw, jhw)
    got = engines[False].preprocess_padded(imgs, bucket, n_slots=4)
    want = jax_engine.preprocess_padded(imgs, bucket, n_slots=4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_empty_padded_batch_is_a_clear_error(engines):
    for engine in engines.values():
        with pytest.raises(ValueError, match="non-empty"):
            engine.enhance_padded_async([], (32, 32))


# ---------------------------------------------------------------------------
# Exactness pins
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("device_preprocess", [False, True], ids=["hostpre", "devpre"])
@pytest.mark.parametrize("hw", [(50, 62), (40, 57)])
def test_interior_bit_identical_and_seam_psnr_bounded(engines, device_preprocess, hw):
    engine = engines[device_preprocess]
    h, w = hw
    img = photo(h, w, 9)
    native = engine.enhance(img[None])[0]
    with DynamicBatcher(engine, BucketLadder([(64, 80)]), max_batch=2, max_wait_ms=5) as b:
        (bucketed,) = b.map_ordered([img])
    assert bucketed.shape == native.shape
    r = RECEPTIVE_RADIUS
    np.testing.assert_array_equal(bucketed[: h - r, : w - r], native[: h - r, : w - r])
    band = np.ones((h, w), bool)
    band[: h - r, : w - r] = False
    assert _psnr(bucketed[band], native[band]) >= BORDER_PSNR_FLOOR_DB


@pytest.mark.parametrize("device_preprocess", [False, True], ids=["hostpre", "devpre"])
def test_output_independent_of_batchmates(engines, mixed_images, device_preprocess):
    engine = engines[device_preprocess]
    ladder = derive_buckets([im.shape[:2] for im in mixed_images], 2)
    with DynamicBatcher(engine, ladder, max_batch=4, max_wait_ms=5) as b:
        together = b.map_ordered(mixed_images)
        alone = [b.map_ordered([im])[0] for im in mixed_images]
    for a, t in zip(alone, together):
        np.testing.assert_array_equal(a, t)


@pytest.mark.parametrize("device_preprocess", [False, True], ids=["hostpre", "devpre"])
def test_bucketed_stream_warms_len_ladder_shapes_and_meets_none_cold(mixed_images, device_preprocess):
    engine = InferenceEngine(weights=TEACHER, device_preprocess=device_preprocess, device="cpu")
    ladder = derive_buckets([im.shape[:2] for im in mixed_images], 2)
    assert len(ladder) == 2
    b = DynamicBatcher(engine, ladder, max_batch=4, max_wait_ms=5)
    shapes_after_warmup = engine.shape_cache_size()
    try:
        outs = b.map_ordered(mixed_images)
    finally:
        b.close()
    assert [o.shape for o in outs] == [im.shape for im in mixed_images]
    summary = b.stats.summary()
    assert summary["compiles"] == len(ladder)
    assert summary["fallback_native_shapes"] == 0
    assert engine.cold_dispatches == 0
    assert engine.shape_cache_size() == shapes_after_warmup == len(ladder)


def test_unwarmed_bucketed_dispatch_counts_cold(engines):
    engine = InferenceEngine(weights=TEACHER, device="cpu")
    img = photo(20, 24, 0)
    engine.enhance_padded([img], (32, 32), n_slots=2)
    assert engine.cold_dispatches == 1
    engine.enhance_padded([img, img], (32, 32), n_slots=2)  # the same shape again
    assert engine.cold_dispatches == 1
    serve = engine.warm_padded(2, (48, 48))
    serve([img])
    assert engine.cold_dispatches == 1


def test_exact_shapes_control_counts_one_shape_per_resolution(mixed_images):
    engine = InferenceEngine(weights=TEACHER, device="cpu")
    exact = ExactShapeBatcher(engine, batch_size=4)
    done = []
    for i, im in enumerate(mixed_images):
        done.extend(exact.push(i, im))
    done.extend(exact.flush())
    assert [k for k, _ in done] == list(range(len(mixed_images)))
    n_unique = len({im.shape for im in mixed_images})
    assert exact.stats.compiles == n_unique == engine.shape_cache_size()


def test_exact_shape_batcher_groups_consecutive_shapes(engines):
    shapes_seen = []
    engine = engines[False]
    orig = engine.enhance

    def recording(frames):
        shapes_seen.append(tuple(frames.shape))
        return orig(frames)

    imgs = [photo(*s, i) for i, s in enumerate([(32, 32)] * 3 + [(48, 32), (32, 32)])]
    engine.enhance = recording
    try:
        exact = ExactShapeBatcher(engine, batch_size=2)
        results = []
        for i, im in enumerate(imgs):
            results.extend(exact.push(i, im))
        results.extend(exact.flush())
    finally:
        del engine.enhance
    assert shapes_seen == [(2, 32, 32, 3), (1, 32, 32, 3), (1, 48, 32, 3), (1, 32, 32, 3)]
    assert [k for k, _ in results] == list(range(5))


@pytest.mark.parametrize("device_preprocess", [False, True], ids=["hostpre", "devpre"])
def test_oversize_request_falls_back_to_native_shape(device_preprocess):
    engine = InferenceEngine(weights=TEACHER, device_preprocess=device_preprocess, device="cpu")
    img = photo(48, 70, 2)
    with DynamicBatcher(engine, BucketLadder([(32, 32)]), max_batch=2, max_wait_ms=5, replicas=2) as b:
        (out,) = b.map_ordered([img])
        stats = b.stats.summary()
    np.testing.assert_array_equal(out, engine.enhance(img[None])[0])
    assert stats["fallback_native_shapes"] == 1
    assert stats["compiles"] == 2 * 1 + 1  # the warmed grid, then the new native shape
    assert stats["per_replica"][0]["requests"] == 1
    assert stats["images_per_sec"] > 0
    assert engine.cold_dispatches == 0  # fallbacks count apart


def test_deadline_flushes_a_partial_batch(engines):
    img = photo(30, 30, 3)
    with DynamicBatcher(engines[False], BucketLadder([(32, 32)]), max_batch=4, max_wait_ms=40) as b:
        out = b.submit(img).result(timeout=60)
    assert out.shape == img.shape
    assert b.stats.summary()["batch_occupancy"] == pytest.approx(0.25)


def test_batcher_rejects_bad_input_unknown_tier_and_use_after_close(engines):
    from waternet_tpu_torch.serving import UnknownTier

    b = DynamicBatcher(engines[False], BucketLadder([(32, 32)]), max_batch=2)
    try:
        with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
            b.submit(np.zeros((4, 4), np.uint8))
        with pytest.raises(ValueError, match="uint8"):
            b.submit(np.zeros((4, 4, 3), np.float32))
        with pytest.raises(UnknownTier, match="not configured on this batcher.*--student-weights"):
            b.submit(np.zeros((4, 4, 3), np.uint8), tier="fast")
        with pytest.raises(UnknownTier, match="unknown tier"):
            b.submit(np.zeros((4, 4, 3), np.uint8), tier="turbo")
    finally:
        b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(np.zeros((4, 4, 3), np.uint8))


# ---------------------------------------------------------------------------
# Replica pool and fault isolation (2 replicas on the CPU)
# ---------------------------------------------------------------------------


def test_resolve_replicas_spec(engines):
    cpu = engines[False]
    assert resolve_replicas("auto", cpu) == resolve_replicas(None, cpu) == 1
    assert resolve_replicas("3", cpu) == 3
    for bad in ("0", "-1", "many"):
        with pytest.raises(ValueError, match="serve-replicas"):
            resolve_replicas(bad, cpu)


@pytest.mark.parametrize("device_preprocess", [False, True], ids=["hostpre", "devpre"])
def test_replica_invariance_and_grid(mixed_images, device_preprocess):
    ladder = derive_buckets([im.shape[:2] for im in mixed_images], 2)
    outs = {}
    for n in (1, 2):
        engine = InferenceEngine(weights=TEACHER, device_preprocess=device_preprocess, device="cpu")
        with DynamicBatcher(engine, ladder, max_batch=2, max_wait_ms=5, replicas=n) as b:
            outs[n] = b.map_ordered(mixed_images)
            summary = b.stats.summary()
        assert summary["compiles"] == len(ladder) * n
        assert summary["replicas"] == n
        assert engine.cold_dispatches == 0
        assert sum(r["requests"] for r in summary["per_replica"]) == len(mixed_images)
    for a, b_ in zip(outs[1], outs[2]):
        np.testing.assert_array_equal(a, b_)


def settle(batcher, timeout=30.0):
    """Drive the pool's supervisor by hand (its own scans are an hour
    apart here) until a quarantined replica is reintegrated and every
    replica is healthy: the quarantine then always comes after the
    re-dispatched batch has run, whatever the thread scheduling."""
    pool = batcher._pool
    _wait_for(lambda: (pool._supervise_once() or True)
              and batcher.stats.summary()["reintegrations"] >= 1
              and all(s == "healthy" for s in batcher.health()["quality"].values()),
              timeout=timeout, what="reintegration")


@pytest.mark.parametrize("plan", ["replica_crash@1", "nan_output@1"])
@pytest.mark.parametrize("n_replicas", [1, 2])
def test_fault_redispatch_is_byte_identical(engines, plan, n_replicas):
    """One batch of 4 through a pool under the plan: the failed batch's
    requests re-dispatch (onto the other replica when there is one), the
    results equal a healthy run's byte for byte, and the counters are
    the plan's: 4 retries, one quarantine, one reintegration through the
    warmed shape (no cold dispatch), one bad output for ``nan_output``.
    ``chip_smoke.py`` phase 12 holds the card's pool to these counters."""
    imgs = [photo(24 + i, 26, i) for i in range(4)]
    ladder = BucketLadder([(32, 32)])
    with DynamicBatcher(engines[False], ladder, max_batch=4, max_wait_ms=5) as b:
        ref = b.map_ordered(imgs)
    engine = InferenceEngine(weights=TEACHER, device="cpu")
    b = DynamicBatcher(engine, ladder, max_batch=4, max_wait_ms=5, replicas=n_replicas,
                       supervision=_sup(scan_interval_sec=3600))
    try:
        faults.install(faults.FaultPlan.parse(plan))
        outs = b.map_ordered(imgs)
        faults.clear()
        for a, r in zip(outs, ref):
            np.testing.assert_array_equal(a, r)
        settle(b)
        s = b.stats.summary()
    finally:
        b.close()
    assert {k: s[k] for k in ("requests", "retried", "nan_outputs", "quarantines", "reintegrations")} == {
        "requests": 4, "retried": 4, "nan_outputs": int(plan.startswith("nan_output")),
        "quarantines": 1, "reintegrations": 1,
    }
    assert s["compiles"] == n_replicas
    assert engine.cold_dispatches == 0


def test_replica_hang_watchdog_redispatches_to_the_other_replica(engines):
    imgs = [photo(24 + i, 26, i) for i in range(4)]
    ladder = BucketLadder([(32, 32)])
    with DynamicBatcher(engines[False], ladder, max_batch=4, max_wait_ms=5) as b:
        ref = b.map_ordered(imgs)
    engine = InferenceEngine(weights=TEACHER, device="cpu")
    b = DynamicBatcher(engine, ladder, max_batch=4, max_wait_ms=5, replicas=2,
                       supervision=_sup(watchdog_sec=2.0))
    try:
        faults.install(faults.FaultPlan.parse("replica_hang@1"))
        outs = b.map_ordered(imgs)
        for a, r in zip(outs, ref):
            np.testing.assert_array_equal(a, r)
        s = b.stats.summary()
        assert s["retried"] == 4 and s["quarantines"] == 1
    finally:
        faults.clear()  # releases the wedged launch thread
        b.close()


def test_output_guard_semantics():
    from waternet_tpu_torch.serving.replicas import _output_ok

    class R:
        def __init__(self, img):
            self.image = img

    live = [R(np.ones((2, 2, 3), np.uint8))]
    dark = [R(np.zeros((2, 2, 3), np.uint8))]
    assert _output_ok(np.full((1, 2, 2, 3), 0.5, np.float32), live)
    assert not _output_ok(np.full((1, 2, 2, 3), np.nan, np.float32), live)
    assert not _output_ok(np.zeros((1, 2, 2, 3), np.float32), live)
    assert _output_ok(np.zeros((1, 2, 2, 3), np.float32), dark)  # black in, black out


# ---------------------------------------------------------------------------
# Against the JAX package's bucketed batcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("device_preprocess", [False, True], ids=["hostpre", "devpre"])
def test_bucketed_output_matches_jax_batcher(engines, mixed_images, device_preprocess):
    ladder = derive_buckets([im.shape[:2] for im in mixed_images], 2)
    with DynamicBatcher(engines[device_preprocess], ladder, max_batch=4, max_wait_ms=5) as b:
        got = b.map_ordered(mixed_images)
    jax_ladder = jax_bucketing.BucketLadder(ladder.buckets)
    jax_engine = JaxEngine(weights=TEACHER, device_preprocess=device_preprocess)
    with JaxBatcher(jax_engine, jax_ladder, max_batch=4, max_wait_ms=5, replicas=1) as jb:
        want = jb.map_ordered(mixed_images)
    diff = np.concatenate([
        np.abs(g.astype(np.int16) - w.astype(np.int16)).ravel() for g, w in zip(got, want)
    ])
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.01


# ---------------------------------------------------------------------------
# The inference CLI's bucketed default
# ---------------------------------------------------------------------------


def _image_dir(root, shapes):
    src = root / "imgs"
    src.mkdir()
    for i, (h, w) in enumerate(shapes):
        cv2.imwrite(str(src / f"im{i}.png"), photo(h, w, 20 + i))
    return src


def test_cli_directory_is_bucketed_and_prints_serving_stats(tmp_path, capsys):
    from waternet_tpu_torch import inference as cli

    shapes = [(32, 32), (40, 52), (30, 30), (52, 40), (48, 60)]
    src = _image_dir(tmp_path, shapes)
    (src / "broken.png").write_bytes(b"not a png")
    cli.main(["--source", str(src), "--weights", TEACHER, "--device", "cpu", "--batch-size", "3",
              "--max-buckets", "2", "--serve-replicas", "2", "--output-root", str(tmp_path / "out")])
    for i, (h, w) in enumerate(shapes):
        out = cv2.imread(str(tmp_path / "out" / "0" / f"im{i}.png"))
        assert out is not None and out.shape == (h, w, 3)
    assert not (tmp_path / "out" / "0" / "broken.png").exists()
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{"serving_stats"')]
    assert len(lines) == 1
    stats = lines[0]["serving_stats"]
    assert stats["requests"] == len(shapes) and stats["replicas"] == 2
    assert stats["compiles"] <= 2 * 2 and stats["fallback_native_shapes"] == 0


def test_cli_directory_equals_the_batcher_and_exact_shapes_equals_enhance(tmp_path):
    """The bucketed files are the batcher's outputs; ``--exact-shapes``
    files are ``engine.enhance`` on each same-shape run."""
    from waternet_tpu_torch import inference as cli

    shapes = [(32, 32), (32, 32), (48, 32), (32, 32)]
    src = _image_dir(tmp_path, shapes)
    args = ["--source", str(src), "--weights", TEACHER, "--device", "cpu", "--batch-size", "2",
            "--workers", "0"]
    cli.main(args + ["--serve-buckets", "48", "--output-root", str(tmp_path / "b")])
    cli.main(args + ["--exact-shapes", "--output-root", str(tmp_path / "e")])
    engine = InferenceEngine(weights=TEACHER, device="cpu")
    rgbs = [cv2.cvtColor(cv2.imread(str(src / f"im{i}.png")), cv2.COLOR_BGR2RGB) for i in range(4)]
    with DynamicBatcher(engine, BucketLadder([(48, 48)]), max_batch=2, max_wait_ms=5) as b:
        bucketed = b.map_ordered(rgbs)
    exact = list(engine.enhance(np.stack(rgbs[:2]))) + [engine.enhance(rgbs[2][None])[0],
                                                       engine.enhance(rgbs[3][None])[0]]
    for i in range(4):
        got_b = cv2.cvtColor(cv2.imread(str(tmp_path / "b" / "0" / f"im{i}.png")), cv2.COLOR_BGR2RGB)
        got_e = cv2.cvtColor(cv2.imread(str(tmp_path / "e" / "0" / f"im{i}.png")), cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(got_b, bucketed[i])
        np.testing.assert_array_equal(got_e, exact[i])


# ---------------------------------------------------------------------------
# The bench's serve line
# ---------------------------------------------------------------------------


def test_bench_serve_line_on_the_cpu(monkeypatch, capsys):
    from waternet_tpu_torch import bench

    for k, v in {"WATERNET_BENCH_HW": "32", "WATERNET_BENCH_SERVE_IMAGES": "12",
                 "WATERNET_BENCH_SERVE_BATCH": "4"}.items():
        monkeypatch.setenv(k, v)
    assert bench.main(["--device", "cpu", "--config", "serve"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "mixed_res_dir_images_per_sec" and line["value"] > 0
    assert line["unit"] == "images/sec/chip" and line["device_kind"] == "cpu"
    assert line["compiles_bucketed"] == len(line["buckets"]) == 3
    assert line["compiles_exact"] == line["unique_shapes"] == 12
    assert line["cold_dispatches"] == 0
    assert 0 < line["batch_occupancy"] <= 1 and 0 <= line["padding_overhead"] < 1


@pytest.mark.parametrize("config,item", [("serve_multi", "item 8"), ("serve_adaptive", "item 6"),
                                         ("serve_chaos", "item 6"), ("serve_fleet", "item 6")])
def test_bench_unported_serve_configs_exit_2(config, item, capsys, monkeypatch):
    """Only item 8's config still exits 2; item 6's now print the line of
    their bench function (stubbed here: tests/test_torch_bench.py runs
    ``stream`` for real)."""
    from waternet_tpu_torch import bench

    if item == "item 6":
        monkeypatch.setitem(bench.SERVING_LINES, config, lambda dev: {"metric": config, "device": str(dev)})
        assert bench.main(["--device", "cpu", "--config", config]) == 0
        assert json.loads(capsys.readouterr().out) == {"metric": config, "device": "cpu"}
        return
    assert bench.main(["--device", "cpu", "--config", config]) == 2
    assert item in capsys.readouterr().err
