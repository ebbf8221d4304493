"""The port's benchmark: training images and video frames per second on one card.

    python -m waternet_tpu_torch.bench                          # three lines
    python -m waternet_tpu_torch.bench --config train_fullres
    python -m waternet_tpu_torch.bench --config video [--batch-size 4]
    python -m waternet_tpu_torch.bench --config serve
    python -m waternet_tpu_torch.bench --config serve_http
    python -m waternet_tpu_torch.bench --config tiers
    python -m waternet_tpu_torch.bench --config stream    # or serve_adaptive, serve_chaos,
                                                          # serve_fleet, stream_reuse, obs,
                                                          # serve_multi, train_chaos
    WATERNET_QUANT=1 python -m waternet_tpu_torch.bench --config video
    python -m waternet_tpu_torch.bench --device cpu             # a smoke run

The JAX package's root ``bench.py`` training lines, ported, on synthetic
pairs (``data/synthetic.py``, seed 0): 2 x batch pairs at HW x HW. Each
line times the train step the trainer runs (on-device augment, the
WB/GC/CLAHE views or their precache tables, the WaterNet forward and
backward, MSE + VGG19 perceptual loss, Adam, SSIM/PSNR): warm-up steps,
one step under ``torch.utils.flop_counter.FlopCounterMode`` (its FLOPs
are ``model_tflop_per_step``), then the timed steps on the host clock,
the device synchronised at their end. Printed in this order:

1. ``uieb_train_images_per_sec_per_chip_hostfed_sync``: a host-fed epoch
   with ``--workers 0`` (the synchronous feed);
2. ``uieb_train_images_per_sec_per_chip_hostfed``: the step on a batch
   already on the device, with the ``pipeline_*`` fields of a pipelined
   epoch (``--workers N``) and the ``--device-preprocess`` vs
   ``--host-preprocess`` A/B (``devpre_*``/``hostpre_*``,
   ``h2d_bytes_reduction``);
3. last, the contract line ``uieb_train_images_per_sec_per_chip``: the
   ``--device-cache`` step, the cache built through ``cache_dataset``
   (with the precache tables by default; ``cache_build_sec``) and timed
   through ``cached_train_step()`` on the first index batch with a fixed
   generator.

``--config video`` is the JAX bench's video line,
``video_1080p_frames_per_sec_per_chip``: a bf16
``InferenceEngine(device_preprocess=True)`` (the port's seeded init) on
``--batch-size`` frames (4) of ``SyntheticPairs(1, h, w, seed=i)`` at
1080 x 1920 (``WATERNET_BENCH_HW`` sets (HW, HW * 16 // 9)):
``WATERNET_BENCH_WARMUP`` untimed calls (at least one), then
``WATERNET_BENCH_STEPS`` double-buffered calls on the host clock, each
uploading the batch and reading back the previous uint8 result, as the
video CLI runs. ``mfu`` is the analytic WaterNet FLOPs of the frames over
the time and the card's bf16 peak. ``WATERNET_QUANT=1`` (the JAX bench's
int8 arm) runs the static int8 engine instead (``quantized`` true,
``precision`` int8, ``mfu`` over the card's int8 peak).

``--config serve`` is the JAX bench's ``mixed_res_dir_images_per_sec``:
a shuffled population of ``WATERNET_BENCH_SERVE_IMAGES`` (48) images,
each of its own shape, in three classes around ``WATERNET_BENCH_HW``
(x1, x1.5, x2, plus jitter), served through the shape-bucketed
``DynamicBatcher`` (``WATERNET_BENCH_SERVE_BUCKETS`` (3) derived buckets,
``WATERNET_BENCH_SERVE_BATCH`` (8) slots) against the ``--exact-shapes``
``ExactShapeBatcher`` on a fresh engine, fp32 with host preprocessing and
the port's seeded init, readback included. ``warmup_sec`` is the pool's
warmup, paid once per server; ``compiles_*`` count warmed entries and
first-met shapes (the port's counterpart of XLA compiles).
``--config serve_http`` is ``http_images_per_sec``: an in-process
``ServingServer`` on an ephemeral port driven by ``serving/loadgen.py``
over real sockets, a serial pass, a closed-loop pass at
``WATERNET_BENCH_SERVE_CONCURRENCY`` (2 x batch) workers (the value) and
a 2x overload pass against a tight admission watermark; ``accounted``
pins that every request ended as ok, shed, deadline or error on both the
client's and the server's count.

``--config tiers`` is the JAX bench's ``fast_tier_images_per_sec``: the
serve population through ONE tier-routing ``DynamicBatcher`` (fp32, host
preprocessing for the quality tier), quality then fast, plus the int8
student through its own batcher; the student is
``WATERNET_STUDENT_WEIGHTS`` or the seeded default 24 x 7 init, the
teacher the local weight resolution or the seeded init.
``ssim_vs_teacher`` compares the two tiers on 4 synthetic frames.

``--config serve_adaptive``, ``serve_chaos``, ``serve_fleet``, ``stream``,
``stream_reuse`` and ``obs`` are the JAX bench's lines of the same names,
ending in its contract metrics ``adaptive_p50_ms``,
``chaos_images_per_sec``, ``fleet_images_per_sec``, ``video_stream_fps``,
``stream_reuse_fps`` and ``obs_overhead_pct`` (each function's docstring
says what it drives); the fast tier in ``serve_chaos`` and ``stream`` is
``WATERNET_STUDENT_WEIGHTS`` or the seeded 24 x 7 init, and
``serve_fleet``'s workers run on the bench's ``--device``.

``--config train_fullres`` is the full-res device-cache A/B at 256 x 256:
the raw cache (with its tables) runs only where the preflight budgeter
says it fits; the contract line ``train_fullres_devcache_images_per_sec``
is the dct8 arm's.

``mfu`` is ``model_tflop_per_step`` over the step time and the card's
peak for the precision (``obs/device.py``); ``mfu_live`` is the analytic
WaterNet figure (3 x ``waternet_forward_flops`` per image) over the same
peak. ``vs_baseline`` divides by 12 images/s: the reference's own PyTorch
trainer on its CUDA GPU at 112 x 112, batch 16 (the JAX bench's
baseline), not a TPU number.

Knobs, as the JAX bench: ``WATERNET_BENCH_{BATCH,HW,WARMUP,STEPS,
PRECISION}`` (16, 112, 3, 30, bf16), ``WATERNET_BENCH_WORKERS`` (2; 0
drops the pipeline lines), ``WATERNET_BENCH_HOSTFED=0`` and
``WATERNET_BENCH_DEVICE_CACHE=0`` drop their lines,
``WATERNET_BENCH_HOSTPRE_AB=0`` the host-preprocess arm, and
``WATERNET_BENCH_FULLRES_{HW,BATCH,PERCEPTUAL}``. A failing arm is not
caught: the run exits non-zero without a last line.

``--config serve_multi`` is ``mixed_res_dir_images_per_sec_multidev``
(the serve population through 1 and N replicas, one a card, byte-checked
``replica_invariant``; with one card both arms run one replica and a
``note`` says so), and ``--config train_chaos`` is
``chaos_train_images_per_sec`` (a supervised 2-process data-parallel
job through a kill and a hang; each function's docstring says what it
drives).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time

import numpy as np
import torch

#: The reference's PyTorch trainer on its CUDA GPU (12 images/s at 112 x 112,
#: batch 16, its host preprocessing included), as the JAX bench divides by.
BASELINE_IMG_PER_SEC = 12.0

#: The JAX bench's configs the port does not run yet, and the ROADMAP item
#: that ports what they drive: none is left.
UNPORTED: dict = {}


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    return int(raw) if raw else default


def _precision() -> str:
    precision = os.environ.get("WATERNET_BENCH_PRECISION", "bf16")
    if precision not in ("bf16", "fp32"):
        raise SystemExit(f"WATERNET_BENCH_PRECISION must be 'bf16' or 'fp32', got {precision!r}")
    return precision


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure_train(dev, batch=None, hw=None, precision=None, warmup=None, steps=None,
                  device_cache=False, pipeline_ab=False, **config_overrides) -> dict:
    """One line: the train step at ``batch`` x ``hw``², fed from a batch
    on the device or (``device_cache``) from the device cache; extra
    keyword arguments go to ``TrainConfig``. ``pipeline_ab`` (host-fed)
    adds the pipeline epochs' fields and the host-preprocess A/B."""
    from torch.utils.flop_counter import FlopCounterMode

    from waternet_tpu_torch.data import codec as cachecodec
    from waternet_tpu_torch.data.synthetic import SyntheticPairs
    from waternet_tpu_torch.models import waternet_forward_flops
    from waternet_tpu_torch.obs.device import hbm_peak_bytes, peak_tflops
    from waternet_tpu_torch.ops.fused import fused_train_preprocess
    from waternet_tpu_torch.training.trainer import TrainConfig, TrainingEngine, step_generator
    from waternet_tpu_torch.utils.tensor import to_device

    batch = _env_int("WATERNET_BENCH_BATCH", 16) if batch is None else batch
    hw = _env_int("WATERNET_BENCH_HW", 112) if hw is None else hw
    precision = _precision() if precision is None else precision
    warmup = max(0, _env_int("WATERNET_BENCH_WARMUP", 3) if warmup is None else warmup)
    steps = max(1, _env_int("WATERNET_BENCH_STEPS", 30) if steps is None else steps)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    config = TrainConfig(batch_size=batch, im_height=hw, im_width=hw, precision=precision, **config_overrides)
    engine = TrainingEngine(config, device=dev)
    data = SyntheticPairs(2 * batch, hw, hw, seed=0)
    idx = np.arange(len(data))
    raw, ref = next(data.batches(idx, batch, shuffle=False, drop_remainder=True))
    raw_d, ref_d = (to_device(torch.from_numpy(a), dev) for a in (raw, ref))
    gen_state = step_generator(0, 0, 0).get_state()

    def gen():  # the same draws every step, as the JAX bench's fixed key
        return torch.Generator().set_state(gen_state)

    if device_cache:
        _sync(dev)
        t0 = time.perf_counter()
        engine.cache_dataset(data, idx)
        _sync(dev)
        cache_build_s = time.perf_counter() - t0
        idx_b, n_real = next(engine._cached_index_batches(len(data), epoch=0, shuffle=False))
        # The trainer's own dispatch, so this times the program --device-cache trains.
        step_fn, cache_args = engine.cached_train_step()

        def step():
            return step_fn(*cache_args, idx_b, gen(), n_real)
    else:
        def step():
            return engine.train_step(raw_d, ref_d, gen(), batch)

    for _ in range(warmup):
        step()
    with FlopCounterMode(display=False) as counter:  # one warm step, counted
        step()
    step_tflop = counter.get_total_flops() / 1e12

    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        m = step()
    _sync(dev)
    step_s = (time.perf_counter() - t0) / steps
    loss = m["loss"].item()
    if not math.isfinite(loss):
        raise RuntimeError(f"the timed steps ended in a non-finite loss ({loss})")

    # The augment + WB/GC/CLAHE stage alone, on the same batch and draws.
    with torch.no_grad():
        fused_train_preprocess(raw_d, ref_d, gen())
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            fused_train_preprocess(raw_d, ref_d, gen())
        _sync(dev)
    pre_s = (time.perf_counter() - t0) / steps

    peak = peak_tflops(dev, precision)
    ips = batch / step_s
    line = {
        "metric": "uieb_train_images_per_sec_per_chip",
        "value": ips,
        "unit": "images/sec/chip",
        "vs_baseline": ips / BASELINE_IMG_PER_SEC,
        "step_ms": step_s * 1e3,
        "preprocess_ms": pre_s * 1e3,
        "model_tflop_per_step": step_tflop,
        "mfu": step_tflop / step_s / peak if peak else None,
        "mfu_live": ips * 3 * waternet_forward_flops(hw, hw) / 1e12 / peak if peak else None,
        "hbm_peak_bytes": hbm_peak_bytes(dev),
        "peak_tflops_assumed": peak,
        "device_kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
        "batch": batch,
        "hw": hw,
        "precision": precision,
    }
    if device_cache:
        codec_name = engine.config.cache_codec
        line.update({
            "device_cache": True,
            "precache_histeq": engine._cache_pre is not None,
            "precache_vgg_ref": engine._cache_pre is not None and engine._cache_pre["vgg_ref"] is not None,
            "cache_build_sec": cache_build_s,
            "cache_codec": codec_name,
            "hbm_cache_bytes": engine.cache_resident_bytes(),
            # Pairs only: the precache tables count in hbm_cache_bytes.
            "cache_compression_ratio": hw * hw * 3 / cachecodec.encoded_bytes_per_image(codec_name, hw, hw),
        })
    elif pipeline_ab and (workers := _env_int("WATERNET_BENCH_WORKERS", 2)) > 0:
        pipe_fields, sync_fields = measure_hostfed_pipeline_ab(engine, workers)
        line.update(pipe_fields)
        line["hostfed_sync"] = sync_fields  # main() prints it as its own line
        if _env_int("WATERNET_BENCH_HOSTPRE_AB", 1):
            line.update(measure_devpre_hostpre_ab(config, pipe_fields, dev, workers))
    return line


def measure_hostfed_pipeline_ab(engine, workers: int, epoch_batches: int = 2):
    """Pipelined against synchronous host-fed epochs on one engine: epoch
    0 warms (one batch), epoch 1 runs ``workers`` threads, epoch 2 the
    inline feed. -> (pipelined fields, sync fields), each the epoch's
    ``pipeline_*`` keys and its ``pipeline_epoch_images_per_sec``."""
    from waternet_tpu_torch.data.synthetic import SyntheticPairs

    cfg = engine.config
    data = SyntheticPairs(epoch_batches * cfg.batch_size, cfg.im_height, cfg.im_width, seed=0)
    idx = np.arange(len(data))
    for i in idx:  # both measured epochs see the same memoized loads
        data.load_pair(int(i))

    def run(epoch, w, subset=None):
        sel = idx if subset is None else idx[:subset]
        t0 = time.perf_counter()
        m = engine.train_epoch_pipelined(data, sel, epoch, workers=w)
        _sync(engine.device)
        out = {k: v for k, v in m.items() if k.startswith("pipeline_")}
        out["pipeline_epoch_images_per_sec"] = len(sel) / (time.perf_counter() - t0)
        return out

    run(0, workers, subset=cfg.batch_size)
    return run(1, workers), run(2, 0)


def measure_devpre_hostpre_ab(config, devpre_fields: dict, dev, workers: int, epoch_batches: int = 2) -> dict:
    """The ``--host-preprocess`` arm (cv2 WB/GC/CLAHE on the workers, five
    float32 views shipped a batch) on a fresh engine over the same
    workload, beside the device-preprocess arm's pipelined epoch."""
    from waternet_tpu_torch.data.synthetic import SyntheticPairs
    from waternet_tpu_torch.training.trainer import TrainingEngine

    hp_cfg = dataclasses.replace(config, host_preprocess=True)
    engine = TrainingEngine(hp_cfg, device=dev)
    data = SyntheticPairs(epoch_batches * hp_cfg.batch_size, hp_cfg.im_height, hp_cfg.im_width, seed=0)
    idx = np.arange(len(data))
    for i in idx:
        data.load_pair(int(i))
    engine.train_epoch_pipelined(data, idx[: hp_cfg.batch_size], 0, workers=workers)
    t0 = time.perf_counter()
    m = engine.train_epoch_pipelined(data, idx, 1, workers=workers)
    _sync(dev)
    dt = time.perf_counter() - t0
    dev_bytes = devpre_fields.get("pipeline_transfer_bytes_per_batch", 0.0)
    host_bytes = m["pipeline_transfer_bytes_per_batch"]
    return {
        "devpre_images_per_sec": devpre_fields.get("pipeline_epoch_images_per_sec"),
        "devpre_transfer_bytes_per_batch": dev_bytes,
        "hostpre_images_per_sec": len(idx) / dt,
        "hostpre_pipeline_stall_pct": m["pipeline_stall_pct"],
        "hostpre_transfer_bytes_per_batch": host_bytes,
        "h2d_bytes_reduction": host_bytes / dev_bytes if dev_bytes else None,
    }


def bench_train_fullres(dev) -> dict:
    """The full-res device-cache A/B: the raw cache with its precache
    tables (only where the budgeter says it fits the headroom;
    ``WATERNET_CACHE_HEADROOM_BYTES`` caps it) against dct8, whose line
    is the contract value. Also the dct8 round trip's PSNR on the
    dataset's frames."""
    from waternet_tpu_torch.data import codec as cachecodec
    from waternet_tpu_torch.data.synthetic import SyntheticPairs

    hw = _env_int("WATERNET_BENCH_FULLRES_HW", 256)
    batch = _env_int("WATERNET_BENCH_FULLRES_BATCH", min(_env_int("WATERNET_BENCH_BATCH", 16), 8))
    n_items = 2 * batch  # measure_train's dataset
    overrides = {}
    if _env_int("WATERNET_BENCH_FULLRES_PERCEPTUAL", 1) == 0:
        overrides["perceptual_weight"] = 0.0

    headroom = cachecodec.resolve_headroom(dev)
    rows = cachecodec.budget_report(n_items, hw, hw, headroom=headroom, precache_histeq=True)
    by_codec = {r["codec"]: r for r in rows}
    raw_line, raw_refused = None, None
    if by_codec["raw"]["fits"] is False:
        raw_refused = (f"preflight budgeter: raw cache needs {by_codec['raw']['cache_bytes']} bytes "
                       f"against {headroom} bytes headroom")
    else:
        try:
            raw_line = measure_train(dev, device_cache=True, hw=hw, batch=batch, cache_codec="raw", **overrides)
        except cachecodec.CacheBudgetError as e:  # the budgeter's refusal, not a failure
            raw_refused = str(e)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    dct_line = measure_train(dev, device_cache=True, hw=hw, batch=batch, cache_codec="dct8", **overrides)

    data = SyntheticPairs(n_items, hw, hw, seed=0)
    sample = np.stack([data.load_pair(i)[0] for i in range(min(n_items, 8))])
    psnr = cachecodec.psnr_db(sample, cachecodec.roundtrip("dct8", sample, dev))
    return {
        "metric": "train_fullres_devcache_images_per_sec",
        "value": dct_line["value"],
        "unit": "images/sec/chip",
        "vs_baseline": dct_line["vs_baseline"],
        "codec": "dct8",
        "hbm_cache_bytes": dct_line["hbm_cache_bytes"],
        "cache_compression_ratio": dct_line["cache_compression_ratio"],
        "cache_build_sec": dct_line["cache_build_sec"],
        "decoded_psnr_db": psnr,
        "step_ms": dct_line["step_ms"],
        "model_tflop_per_step": dct_line["model_tflop_per_step"],
        "mfu": dct_line["mfu"],
        "mfu_live": dct_line["mfu_live"],
        "hbm_peak_bytes": dct_line["hbm_peak_bytes"],
        "peak_tflops_assumed": dct_line["peak_tflops_assumed"],
        "device_kind": dct_line["device_kind"],
        "raw_fits": by_codec["raw"]["fits"],
        "raw_refused": raw_refused,
        "raw_images_per_sec": raw_line["value"] if raw_line else None,
        "raw_step_ms": raw_line["step_ms"] if raw_line else None,
        "raw_hbm_cache_bytes": raw_line["hbm_cache_bytes"] if raw_line else None,
        "raw_precache_histeq": raw_line["precache_histeq"] if raw_line else None,
        "headroom_bytes": headroom,
        "n_items": n_items,
        "batch": batch,
        "hw": hw,
        "precision": dct_line["precision"],
    }


def bench_video(dev, batch: int = 4, quantize: bool = False) -> dict:
    """The video line: double-buffered bf16 (or, with ``quantize``, static
    int8) enhancement of ``batch`` 1080p frames a call, upload and uint8
    readback included."""
    from waternet_tpu_torch.data.synthetic import SyntheticPairs
    from waternet_tpu_torch.hub import init_state_dict
    from waternet_tpu_torch.inference_engine import InferenceEngine
    from waternet_tpu_torch.models import waternet_forward_flops
    from waternet_tpu_torch.obs.device import hbm_peak_bytes, peak_tflops
    from waternet_tpu_torch.utils.tensor import ten2arr

    hw = _env_int("WATERNET_BENCH_HW", 0)
    h, w = (hw, hw * 16 // 9) if hw else (1080, 1920)
    warmup = max(1, _env_int("WATERNET_BENCH_WARMUP", 3))
    steps = max(1, _env_int("WATERNET_BENCH_STEPS", 30))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    engine = InferenceEngine(params=init_state_dict(0), device_preprocess=True, device=dev,
                             dtype=torch.bfloat16, quantize=quantize)
    frames = np.stack([SyntheticPairs(1, h, w, seed=i).load_pair(0)[0] for i in range(batch)])
    for _ in range(warmup):
        ten2arr(engine.enhance_async(frames))

    t0 = time.perf_counter()
    pending = engine.enhance_async(frames)
    for _ in range(steps - 1):
        nxt = engine.enhance_async(frames)
        ten2arr(pending)
        pending = nxt
    out = ten2arr(pending)
    dt = time.perf_counter() - t0
    if out.shape != frames.shape or out.dtype != np.uint8:
        raise RuntimeError(f"the video engine returned {out.dtype} {out.shape} for {frames.shape}")
    fps = batch * steps / dt
    precision = "int8" if quantize else "bf16"
    peak = peak_tflops(dev, precision)
    return {
        "metric": "video_1080p_frames_per_sec_per_chip",
        "value": fps,
        "unit": "frames/sec/chip",
        "vs_baseline": None,
        "batch": batch,
        "frame_ms": dt / (batch * steps) * 1e3,
        "quantized": quantize,
        "mfu": fps * waternet_forward_flops(h, w) / 1e12 / peak if peak else None,
        "hbm_peak_bytes": hbm_peak_bytes(dev),
        "peak_tflops_assumed": peak,
        "device_kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
        "hw": [h, w],
        "precision": precision,
    }


def _serving_env_defaults(n_images, max_batch, max_buckets):
    """The serve configs' shared workload knobs: explicit args win, else
    the ``WATERNET_BENCH_SERVE_*`` env defaults."""
    return (
        _env_int("WATERNET_BENCH_SERVE_IMAGES", 48) if n_images is None else n_images,
        _env_int("WATERNET_BENCH_SERVE_BATCH", 8) if max_batch is None else max_batch,
        _env_int("WATERNET_BENCH_SERVE_BUCKETS", 3) if max_buckets is None else max_buckets,
    )


def _serving_population(n_images, base):
    """The serving benches' shared workload (the JAX bench's): three
    resolution classes with per-image jitter, deduplicated so every image
    really is its own shape, shuffled so shapes interleave."""
    rng = np.random.default_rng(0)
    shapes = []
    seen = set()
    for i in range(n_images):
        scale = (1.0, 1.5, 2.0)[i % 3]
        h = int(base * scale) + int(rng.integers(0, 8))
        w = int(base * scale * 4 // 3) + int(rng.integers(0, 8))
        while (h, w) in seen:
            w += 1
        seen.add((h, w))
        shapes.append((h, w))
    rng.shuffle(shapes)
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in shapes]
    return images, shapes


def _device_kind(dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)


def _pngs(images) -> list:
    """Each RGB image as PNG file bytes, the uploads of the HTTP lines."""
    import cv2

    return [cv2.imencode(".png", im[:, :, ::-1])[1].tobytes() for im in images]


def bench_serving(dev, n_images=None, max_batch=None, max_buckets=None, base_hw=None) -> dict:
    """``mixed_res_dir_images_per_sec``: the bucketed batcher against the
    exact-shape batcher on one population, end to end (host preprocessing
    and readback included; warmup reported apart)."""
    from waternet_tpu_torch.hub import init_state_dict
    from waternet_tpu_torch.inference_engine import InferenceEngine
    from waternet_tpu_torch.serving import DynamicBatcher, ExactShapeBatcher, derive_buckets

    n_images, max_batch, max_buckets = _serving_env_defaults(n_images, max_batch, max_buckets)
    base = _env_int("WATERNET_BENCH_HW", 112) if base_hw is None else base_hw
    params = init_state_dict(0)
    images, shapes = _serving_population(n_images, base)
    ladder = derive_buckets(shapes, max_buckets=max_buckets)

    engine = InferenceEngine(params=params, device=dev)
    t0 = time.perf_counter()
    batcher = DynamicBatcher(engine, ladder, max_batch=max_batch)
    warmup_s = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        outs = batcher.map_ordered(images)
        bucketed_s = time.perf_counter() - t0
    finally:
        batcher.close()
    if [o.shape for o in outs] != [im.shape for im in images]:
        raise RuntimeError("the bucketed batcher returned other shapes than it was given")
    summary = batcher.stats.summary()

    # A fresh engine for the A/B: the exact-shape path meets every shape cold.
    engine_exact = InferenceEngine(params=params, device=dev)
    exact = ExactShapeBatcher(engine_exact, max_batch)
    t0 = time.perf_counter()
    done = sum(len(exact.push(i, im)) for i, im in enumerate(images))
    done += len(exact.flush())
    exact_s = time.perf_counter() - t0
    if done != n_images:
        raise RuntimeError(f"the exact-shape batcher returned {done} of {n_images} images")

    bucketed_ips = n_images / bucketed_s
    exact_ips = n_images / exact_s
    return {
        "metric": "mixed_res_dir_images_per_sec",
        "value": bucketed_ips,
        "unit": "images/sec/chip",
        "vs_baseline": None,
        "exact_shapes_images_per_sec": exact_ips,
        "speedup_vs_exact": bucketed_ips / exact_ips,
        "buckets": ladder.describe(),
        "batch_occupancy": summary["batch_occupancy"],
        "padding_overhead": summary["padding_overhead"],
        "compiles_bucketed": summary["compiles"],
        "compiles_exact": exact.stats.compiles,
        "cold_dispatches": engine.cold_dispatches,
        "latency_ms": summary["latency_ms"],
        "warmup_sec": warmup_s,
        "n_images": n_images,
        "unique_shapes": len(set(shapes)),
        "max_batch": max_batch,
        "device_kind": _device_kind(dev),
    }


def bench_serving_multi(dev, n_images=None, max_batch=None, max_buckets=None, base_hw=None,
                        replicas=None) -> dict:
    """``mixed_res_dir_images_per_sec_multidev``: the serve population
    through a 1-replica pool and then an N-replica pool on the same ladder
    and batch size, N = ``torch.cuda.device_count()`` (1 on the CPU;
    ``WATERNET_BENCH_SERVE_REPLICAS`` overrides), each replica on its own
    card. The two arms' outputs are byte-compared (``replica_invariant``).
    With one card both arms run one replica, and ``note`` says so: the
    line then measures nothing of scale-out."""
    from waternet_tpu_torch.hub import init_state_dict
    from waternet_tpu_torch.inference_engine import InferenceEngine
    from waternet_tpu_torch.serving import DynamicBatcher, derive_buckets

    n_images, max_batch, max_buckets = _serving_env_defaults(n_images, max_batch, max_buckets)
    base = _env_int("WATERNET_BENCH_HW", 112) if base_hw is None else base_hw
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 1
    n_replicas = _env_int("WATERNET_BENCH_SERVE_REPLICAS", n_cards) if replicas is None else replicas
    if dev.type == "cuda":
        n_replicas = max(1, min(n_replicas, n_cards))
    params = init_state_dict(0)
    images, shapes = _serving_population(n_images, base)
    ladder = derive_buckets(shapes, max_buckets=max_buckets)

    def run(n_rep):
        engine = InferenceEngine(params=params, device=dev)
        t0 = time.perf_counter()
        batcher = DynamicBatcher(engine, ladder, max_batch=max_batch, replicas=n_rep)
        warmup_s = time.perf_counter() - t0
        try:
            t0 = time.perf_counter()
            outs = batcher.map_ordered(images)
            serve_s = time.perf_counter() - t0
        finally:
            batcher.close()
        if len(outs) != n_images:
            raise RuntimeError(f"the {n_rep}-replica pool returned {len(outs)} of {n_images} images")
        return outs, n_images / serve_s, warmup_s, batcher.stats.summary()

    outs_1, ips_1, warmup_1, _ = run(1)
    outs_n, ips_n, warmup_n, summary = run(n_replicas)
    line = {
        "metric": "mixed_res_dir_images_per_sec_multidev",
        "value": ips_n,
        "unit": "images/sec",
        "vs_baseline": None,
        "replicas": n_replicas,
        "images_per_sec_1replica": ips_1,
        "speedup_vs_1_replica": ips_n / ips_1,
        "replica_invariant": all(np.array_equal(a, b) for a, b in zip(outs_1, outs_n)),
        "buckets": ladder.describe(),
        "compiles": summary["compiles"],
        "batch_occupancy": summary["batch_occupancy"],
        "padding_overhead": summary["padding_overhead"],
        "fallback_native_shapes": summary["fallback_native_shapes"],
        "latency_ms": summary["latency_ms"],
        "load_imbalance": summary["load_imbalance"],
        "per_replica": summary["per_replica"],
        "warmup_sec_1replica": warmup_1,
        "warmup_sec": warmup_n,
        "n_images": n_images,
        "unique_shapes": len(set(shapes)),
        "max_batch": max_batch,
        "host_cpus": os.cpu_count(),
        "device_kind": _device_kind(dev),
    }
    if n_replicas == 1:
        line["note"] = (f"{n_cards} device(s) visible: both arms ran one replica, so this line "
                        "measures no scale-out; replica_invariant is still byte-checked")
    return line


def bench_serving_http(dev, n_images=None, max_batch=None, max_buckets=None, base_hw=None,
                       concurrency=None, requests_per_phase=None) -> dict:
    """``http_images_per_sec``: the front door end to end over sockets, in
    three phases (serial, closed loop, 2x overload against a tight
    watermark), with the accounting cross-checked against the server."""
    from waternet_tpu_torch.hub import init_state_dict
    from waternet_tpu_torch.inference_engine import InferenceEngine
    from waternet_tpu_torch.serving import derive_buckets
    from waternet_tpu_torch.serving.loadgen import run_load
    from waternet_tpu_torch.serving.server import ServingServer

    n_images, max_batch, max_buckets = _serving_env_defaults(n_images, max_batch, max_buckets)
    base = _env_int("WATERNET_BENCH_HW", 112) if base_hw is None else base_hw
    concurrency = (_env_int("WATERNET_BENCH_SERVE_CONCURRENCY", 2 * max_batch)
                   if concurrency is None else concurrency)
    n_req = (_env_int("WATERNET_BENCH_SERVE_REQUESTS", 2 * n_images)
             if requests_per_phase is None else requests_per_phase)

    images, shapes = _serving_population(n_images, base)
    ladder = derive_buckets(shapes, max_buckets=max_buckets)
    payloads = _pngs(images)
    engine = InferenceEngine(params=init_state_dict(0), device=dev)
    server = ServingServer(
        engine, ladder, max_batch=max_batch, max_wait_ms=5.0, replicas=1,
        # Tight bound so the 2x phase sheds: ~2 batches of undispatched work.
        max_queue=4 * max_batch, admit_watermark=2 * max_batch,
    )
    t0 = time.perf_counter()
    server.start_background()
    try:
        server.wait_ready()
        warmup_s = time.perf_counter() - t0
        unloaded = run_load(server.url, payloads, concurrency=1, total=min(n_req, 16))
        loaded = run_load(server.url, payloads, concurrency=concurrency, total=n_req)
        overload = run_load(server.url, payloads, concurrency=2 * concurrency, total=n_req)
    finally:
        server.request_drain()
        code = server.join()
    if code != 0:
        raise RuntimeError(f"the server's drain ended with exit code {code}")
    summary = server.stats.summary()
    phases = (unloaded, loaded, overload)
    accounted = (
        summary["requests"] == sum(p["ok"] for p in phases)
        and summary["shed_count"] == sum(p["shed"] for p in phases)
        and summary["deadline_expired"] == sum(p["deadline_expired"] for p in phases)
        and all(p["errors"] == 0 for p in phases)
        and all(p["conn_reset"] == 0 for p in phases)
    )
    return {
        "metric": "http_images_per_sec",
        "value": loaded["images_per_sec"],
        "unit": "images/sec",
        "vs_baseline": None,
        "p50_ms": loaded["latency_ms"]["p50"],
        "p99_ms": loaded["latency_ms"]["p99"],
        "p99_unloaded_ms": unloaded["latency_ms"]["p99"],
        "shed_rate_at_2x": overload["shed"] / overload["sent"] if overload["sent"] else 0.0,
        "images_per_sec_at_2x": overload["images_per_sec"],
        "p99_ms_at_2x": overload["latency_ms"]["p99"],
        "accounted": bool(accounted),
        "shed_count": summary["shed_count"],
        "deadline_expired": summary["deadline_expired"],
        "queue_depth_max": summary["queue_depth_max"],
        "batch_occupancy": summary["batch_occupancy"],
        "padding_overhead": summary["padding_overhead"],
        "compiles": summary["compiles"],
        "cold_dispatches": engine.cold_dispatches,
        "buckets": ladder.describe(),
        "warmup_sec": warmup_s,
        "concurrency": concurrency,
        "requests_per_phase": n_req,
        "n_images": n_images,
        "max_batch": max_batch,
        "device_kind": _device_kind(dev),
    }


def bench_tiers(dev, n_images=None, max_batch=None, max_buckets=None, base_hw=None) -> dict:
    """``fast_tier_images_per_sec``: the same population through one
    tier-routing batcher, quality (fp32 WaterNet with host WB/GC/CLAHE)
    then fast (the CAN student, raw RGB in), and the int8 student through
    its own batcher; the JAX bench's field names."""
    from waternet_tpu_torch.data.synthetic import SyntheticPairs
    from waternet_tpu_torch.hub import init_state_dict, resolve_weights
    from waternet_tpu_torch.inference_engine import InferenceEngine, StudentEngine
    from waternet_tpu_torch.models.can import flops_ratio
    from waternet_tpu_torch.serving import DynamicBatcher, derive_buckets
    from waternet_tpu_torch.training.metrics import ssim as ssim_fn

    n_images, max_batch, max_buckets = _serving_env_defaults(n_images, max_batch, max_buckets)
    base = _env_int("WATERNET_BENCH_HW", 112) if base_hw is None else base_hw
    params = resolve_weights(None)
    pretrained_teacher = params is not None
    if params is None:
        params = init_state_dict(0)
    student_params, distilled = _student_params()
    images, shapes = _serving_population(n_images, base)
    ladder = derive_buckets(shapes, max_buckets=max_buckets)

    engine = InferenceEngine(params=params, device=dev)
    fast = StudentEngine(params=student_params, device=dev)
    t0 = time.perf_counter()
    batcher = DynamicBatcher(engine, ladder, max_batch=max_batch, fast_engine=fast)
    warmup_s = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        outs_q = batcher.map_ordered(images)
        teacher_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        outs_f = batcher.map_ordered(images, tier="fast")
        fast_s = time.perf_counter() - t0
    finally:
        batcher.close()
    summary = batcher.stats.summary()
    if [o.shape for o in outs_q] != [im.shape for im in images] or len(outs_f) != n_images:
        raise RuntimeError("the tier-routing batcher returned other shapes than it was given")

    # The int8 student through the same bucketed machinery (its own batcher).
    fast_q8 = StudentEngine(
        params=student_params, quantize=True, device=dev,
        calib_batches=[im[None].astype(np.float32) / 255.0 for im in images[:4]],
    )
    b8 = DynamicBatcher(fast_q8, ladder, max_batch=max_batch, tier_name="fast")
    try:
        t0 = time.perf_counter()
        outs_8 = b8.map_ordered(images)
        int8_s = time.perf_counter() - t0
    finally:
        b8.close()

    # The fast tier against the quality tier on plausible frames (noise is
    # out of distribution for both, and its SSIM is ~0 by construction).
    fid = SyntheticPairs(4, base, base, seed=0)
    frames = np.stack([fid.load_pair(i)[0] for i in range(4)])
    as_t = lambda a: torch.from_numpy(a).to(torch.float32) / 255.0  # noqa: E731
    ssim = float(ssim_fn(as_t(fast.enhance(frames)), as_t(engine.enhance(frames)), data_range=1.0))
    int8_err = float(np.mean([np.abs(a.astype(int) - b.astype(int)).mean() for a, b in zip(outs_8, outs_f)]))

    teacher_ips, fast_ips = n_images / teacher_s, n_images / fast_s
    return {
        "metric": "fast_tier_images_per_sec",
        "value": fast_ips,
        "unit": "images/sec/chip",
        "vs_baseline": None,
        "teacher_images_per_sec": teacher_ips,
        "speedup_vs_teacher": fast_ips / teacher_ips,
        "flop_ratio": flops_ratio(base, base, fast.width, fast.depth),
        "ssim_vs_teacher": ssim,
        "distilled_student": distilled,
        "pretrained_teacher": pretrained_teacher,
        "int8_images_per_sec": n_images / int8_s,
        "int8_speedup_vs_teacher": (n_images / int8_s) / teacher_ips,
        "int8_vs_float_student_mean_abs_lvl": int8_err,
        "student_width": fast.width,
        "student_depth": fast.depth,
        "tiers": summary["tiers"],
        "buckets": ladder.describe(),
        "compiles": summary["compiles"],
        "cold_dispatches": engine.cold_dispatches + fast.cold_dispatches + fast_q8.cold_dispatches,
        "warmup_sec": warmup_s,
        "n_images": n_images,
        "max_batch": max_batch,
        "device_kind": _device_kind(dev),
    }


def _student_params():
    """The fast tier's weights: ``WATERNET_STUDENT_WEIGHTS`` or the seeded
    default 24 x 7 init -> (state_dict, distilled?)."""
    from waternet_tpu_torch.hub import resolve_weights
    from waternet_tpu_torch.models import CANStudent

    path = os.environ.get("WATERNET_STUDENT_WEIGHTS")
    if path:
        return resolve_weights(path), True
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        return CANStudent().state_dict(), False


def bench_obs(dev, n_images=None, max_batch=None, max_buckets=None, base_hw=None) -> dict:
    """``obs_overhead_pct``: the serve population through ONE warmed
    batcher with the whole observability stack off, then on (the trace
    ring, the sliding windows and an armed SLO engine; no export),
    interleaved over ``WATERNET_BENCH_OBS_ROUNDS`` (3) rounds, best of each
    arm. The two arms' outputs must be byte-identical; the SLO grade is read
    outside the timed region, as a scrape would."""
    from waternet_tpu_torch.hub import init_state_dict
    from waternet_tpu_torch.inference_engine import InferenceEngine
    from waternet_tpu_torch.obs import trace
    from waternet_tpu_torch.obs import window as obswin
    from waternet_tpu_torch.obs.slo import SloEngine, parse_slo
    from waternet_tpu_torch.serving import DynamicBatcher, derive_buckets

    n_images, max_batch, max_buckets = _serving_env_defaults(n_images, max_batch, max_buckets)
    base = _env_int("WATERNET_BENCH_HW", 112) if base_hw is None else base_hw
    rounds = _env_int("WATERNET_BENCH_OBS_ROUNDS", 3)
    images, shapes = _serving_population(n_images, base)
    ladder = derive_buckets(shapes, max_buckets=max_buckets)
    engine = InferenceEngine(params=init_state_dict(0), device=dev)
    t0 = time.perf_counter()
    batcher = DynamicBatcher(engine, ladder, max_batch=max_batch)
    warmup_s = time.perf_counter() - t0
    batcher.stats.arm_slo(SloEngine(parse_slo("p99_ms<=250,error_rate<=0.01,availability>=0.999")))

    trace.disable()
    trace.reset()
    obswin.disable()
    best_off = best_on = float("inf")
    ref_outs = traced_outs = None
    slo_grade = None
    try:
        batcher.map_ordered(images)  # neither arm pays first-execution costs
        for _ in range(rounds):
            trace.disable()
            obswin.disable()
            t0 = time.perf_counter()
            outs = batcher.map_ordered(images)
            best_off = min(best_off, time.perf_counter() - t0)
            if ref_outs is None:
                ref_outs = outs
            trace.reset()
            trace.enable()
            obswin.enable()
            t0 = time.perf_counter()
            traced_outs = batcher.map_ordered(images)
            best_on = min(best_on, time.perf_counter() - t0)
            trace.disable()
            obswin.disable()
            slo_grade = batcher.stats.summary()["slo"]["grade"]
        spans = trace.counters()
    finally:
        trace.disable()
        trace.reset()
        obswin.enable()  # windows are on by default process-wide
        batcher.close()
    identical = all(np.array_equal(a, b) for a, b in zip(ref_outs, traced_outs))
    off_ips, on_ips = n_images / best_off, n_images / best_on
    return {
        "metric": "obs_overhead_pct",
        "value": (off_ips - on_ips) / off_ips * 100.0,
        "unit": "percent",
        "vs_baseline": None,
        "tracing_off_images_per_sec": off_ips,
        "tracing_on_images_per_sec": on_ips,
        "spans_per_traced_run": spans["spans"],
        "spans_evicted": spans["evicted"],
        "byte_identical": bool(identical),
        "windowed": True,
        "slo_armed": True,
        "slo_grade": slo_grade,
        "rounds": rounds,
        "warmup_sec": warmup_s,
        "n_images": n_images,
        "max_batch": max_batch,
        "device_kind": _device_kind(dev),
    }


def bench_serve_adaptive(dev, n_images=None, max_batch=None, max_buckets=None, requests_per_phase=None) -> dict:
    """``adaptive_p50_ms``: fixed against adaptive coalescing on the HTTP
    front door, two servers over the same ladder and payloads, at three
    regimes: low (serial closed loop; the adaptive window collapses, the
    contract value is its p50), high (open-loop Poisson at 1.3x the fixed
    arm's measured capacity, the same seeded schedule on both arms) and
    mid (half the fixed arm's sustained overload rate). The low phase's
    answers must be byte-identical across the arms, and neither arm may
    meet a new shape mid-serve."""
    from waternet_tpu_torch.hub import init_state_dict
    from waternet_tpu_torch.inference_engine import InferenceEngine
    from waternet_tpu_torch.serving import derive_buckets
    from waternet_tpu_torch.serving.loadgen import run_load
    from waternet_tpu_torch.serving.server import ServingServer

    n_images, max_batch, max_buckets = _serving_env_defaults(n_images, max_batch, max_buckets)
    base = _env_int("WATERNET_BENCH_HW", 112)
    n_req = (_env_int("WATERNET_BENCH_SERVE_REQUESTS", 2 * n_images)
             if requests_per_phase is None else requests_per_phase)
    # A cap tall enough that the fixed hold dominates the unloaded p50.
    max_wait_ms = float(os.environ.get("WATERNET_BENCH_ADAPTIVE_WAIT", 40.0))
    params = init_state_dict(0)
    images, shapes = _serving_population(n_images, base)
    ladder = derive_buckets(shapes, max_buckets=max_buckets)
    payloads = _pngs(images)

    def run_arm(coalesce: str, high_rate, mid_rate):
        engine = InferenceEngine(params=params, device=dev)
        server = ServingServer(engine, ladder, max_batch=max_batch, max_wait_ms=max_wait_ms, replicas=1,
                               coalesce=coalesce)
        t0 = time.perf_counter()
        server.start_background()
        try:
            server.wait_ready()
            warmup_s = time.perf_counter() - t0
            compiles_warm = server.stats.summary()["compiles"]
            low = run_load(server.url, payloads, concurrency=1, total=min(n_req, 16), keep_bodies=True)
            # Unmeasured priming wave; on the fixed arm also the capacity probe.
            prime = run_load(server.url, payloads, concurrency=4 * max_batch, total=4 * max_batch)
            if high_rate is None:
                high_rate = max(1.0, 1.3 * prime["images_per_sec"])
            high = run_load(server.url, payloads, concurrency=8 * max_batch, total=2 * n_req,
                            arrival_rate=high_rate)
            if mid_rate is None:
                mid_rate = max(1.0, high["images_per_sec"] / 2.0)
            mid = run_load(server.url, payloads, concurrency=2 * max_batch, total=n_req, arrival_rate=mid_rate)
        finally:
            server.request_drain()
            server.join()
        summary = server.stats.summary()
        return {"low": low, "mid": mid, "high": high, "high_rate": high_rate, "mid_rate": mid_rate,
                "summary": summary, "compiles_mid_serve": summary["compiles"] - compiles_warm,
                "cold_dispatches": engine.cold_dispatches, "warmup_sec": warmup_s}

    fixed = run_arm("fixed", None, None)
    adaptive = run_arm("adaptive", fixed["high_rate"], fixed["mid_rate"])
    fixed_bodies = {i: body for i, st, body in fixed["low"]["bodies"] if st == 200}
    byte_identical = len(adaptive["low"]["bodies"]) == len(fixed["low"]["bodies"]) and all(
        st == 200 and fixed_bodies.get(i) == body for i, st, body in adaptive["low"]["bodies"])
    p50_fixed = fixed["low"]["latency_ms"]["p50"]
    p50_adapt = adaptive["low"]["latency_ms"]["p50"]
    ips_fixed, ips_adapt = fixed["high"]["images_per_sec"], adaptive["high"]["images_per_sec"]
    return {
        "metric": "adaptive_p50_ms",
        "value": p50_adapt,
        "unit": "ms",
        "vs_baseline": None,
        "p50_unloaded_fixed_ms": p50_fixed,
        "p50_unloaded_delta_pct": (1.0 - p50_adapt / p50_fixed) * 100.0 if p50_fixed else 0.0,
        "p50_mid_fixed_ms": fixed["mid"]["latency_ms"]["p50"],
        "p50_mid_adaptive_ms": adaptive["mid"]["latency_ms"]["p50"],
        "mid_arrival_rate": fixed["mid_rate"],
        "high_arrival_rate": fixed["high_rate"],
        "images_per_sec_fixed": ips_fixed,
        "images_per_sec_adaptive": ips_adapt,
        "throughput_ratio": ips_adapt / ips_fixed if ips_fixed else 0.0,
        "batch_occupancy_fixed": fixed["summary"]["batch_occupancy"],
        "batch_occupancy_adaptive": adaptive["summary"]["batch_occupancy"],
        "eff_wait_ms": adaptive["summary"].get("eff_wait_ms", {}),
        "byte_identical": bool(byte_identical),
        "compiles_mid_serve_fixed": fixed["compiles_mid_serve"],
        "compiles_mid_serve_adaptive": adaptive["compiles_mid_serve"],
        "cold_dispatches": fixed["cold_dispatches"] + adaptive["cold_dispatches"],
        "max_wait_ms": max_wait_ms,
        "buckets": ladder.describe(),
        "requests_per_phase": n_req,
        "n_images": n_images,
        "max_batch": max_batch,
        "warmup_sec": fixed["warmup_sec"] + adaptive["warmup_sec"],
        "device_kind": _device_kind(dev),
    }


def bench_serving_chaos(dev, n_images=None, max_batch=None, max_buckets=None, base_hw=None, concurrency=None,
                        requests=None, watchdog_sec=5.0, fault_spec="replica_crash@2,replica_hang@5") -> dict:
    """``chaos_images_per_sec``: a supervised two-tier server on min(2,
    devices) replicas a tier, driven closed-loop with brown-out opt-in
    traffic while ``fault_spec`` crashes one batch and hangs another. One
    card (or the CPU) gives one replica a tier: the faulted replica itself
    is quarantined, re-warmed and reintegrated while its batches wait
    (``replicas`` and ``note`` say so). ``accounted`` reconciles the
    client's ledger with the server's ``/stats``. ``watchdog_sec`` must
    clear the workload's worst healthy batch, or the line measures false
    quarantines; the hang is released at the end of the run."""
    from waternet_tpu_torch.hub import init_state_dict
    from waternet_tpu_torch.inference_engine import InferenceEngine, StudentEngine
    from waternet_tpu_torch.resilience import faults
    from waternet_tpu_torch.serving import SupervisionConfig, derive_buckets
    from waternet_tpu_torch.serving.loadgen import run_load
    from waternet_tpu_torch.serving.replicas import resolve_replicas
    from waternet_tpu_torch.serving.server import ServingServer

    n_images, max_batch, max_buckets = _serving_env_defaults(n_images, max_batch, max_buckets)
    base = _env_int("WATERNET_BENCH_HW", 112) if base_hw is None else base_hw
    concurrency = (_env_int("WATERNET_BENCH_SERVE_CONCURRENCY", 2 * max_batch)
                   if concurrency is None else concurrency)
    n_req = _env_int("WATERNET_BENCH_SERVE_REQUESTS", 2 * n_images) if requests is None else requests
    images, shapes = _serving_population(n_images, base)
    ladder = derive_buckets(shapes, max_buckets=max_buckets)
    payloads = _pngs(images)
    engine = InferenceEngine(params=init_state_dict(0), device=dev)
    replicas = min(2, resolve_replicas("auto", engine))
    server = ServingServer(
        engine, ladder, max_batch=max_batch, max_wait_ms=5.0, replicas=replicas,
        max_queue=8 * max_batch, admit_watermark=4 * max_batch,
        fast_engine=StudentEngine(params=_student_params()[0], device=dev),
        # Below the closed loop's depth, or the downgrade arm never fires.
        downgrade_watermark=max(2, concurrency // 2),
        supervision=SupervisionConfig(watchdog_sec=watchdog_sec, rewarm_backoff_sec=0.05, scan_interval_sec=0.01),
    )
    t0 = time.perf_counter()
    server.start_background()
    try:
        server.wait_ready()
        warmup_s = time.perf_counter() - t0
        faults.install(faults.FaultPlan.parse(fault_spec))
        try:
            t0 = time.perf_counter()
            loaded = run_load(server.url, payloads, concurrency=concurrency, total=n_req, tier="quality",
                              allow_downgrade=True)
            chaos_s = time.perf_counter() - t0
        finally:
            faults.clear()  # releases the injected hang
        deadline = time.monotonic() + 60.0
        recovered = False
        while time.monotonic() < deadline:
            s = server.stats.summary()
            if s["reintegrations"] >= s["quarantines"]:
                recovered = True
                break
            time.sleep(0.05)
    finally:
        server.request_drain()
        server.join()
    summary = server.stats.summary()
    accounted = (
        summary["requests"] == loaded["ok"]
        and summary["shed_count"] == loaded["shed"]
        # The server counts a downgrade when it routes, the client when it
        # is answered: one that then failed shows on the server's side only.
        and summary["downgraded"] >= loaded["downgraded"]
        and summary["deadline_expired"] == loaded["deadline_expired"]
        and loaded["errors"] == 0
        and loaded["conn_reset"] == 0
    )
    return {
        "metric": "chaos_images_per_sec",
        "value": loaded["ok"] / chaos_s if chaos_s else 0.0,
        "unit": "images/sec",
        "vs_baseline": None,
        "replicas": replicas,
        "note": ("one replica a tier: the faulted replica itself is quarantined, re-warmed and reintegrated"
                 if replicas == 1 else "the faulted replica's batches re-dispatch to the other replica"),
        "faults": fault_spec,
        "watchdog_sec": watchdog_sec,
        "quarantines": summary["quarantines"],
        "reintegrations": summary["reintegrations"],
        "recovered": bool(recovered),
        "recovery_sec": summary["recovery_sec_max"],
        "retried": summary["retried"],
        "downgraded": summary["downgraded"],
        "nan_outputs": summary["nan_outputs"],
        "shed_count": summary["shed_count"],
        "deadline_expired": summary["deadline_expired"],
        "conn_reset": loaded["conn_reset"],
        "errors": loaded["errors"],
        "accounted": bool(accounted),
        "replica_health": summary["replica_health"],
        "p99_ms": loaded["latency_ms"]["p99"],
        "buckets": ladder.describe(),
        "compiles": summary["compiles"],
        "warmup_sec": warmup_s,
        "concurrency": concurrency,
        "requests": n_req,
        "n_images": n_images,
        "max_batch": max_batch,
        "device_kind": _device_kind(dev),
    }


def bench_serving_fleet(dev, n_images=None, max_batch=None, max_buckets=None, base_hw=None, concurrency=None,
                        requests=None, workers=3, crash_at=None, hang_at=None) -> dict:
    """``fleet_images_per_sec``: ``workers`` (3)
    ``python -m waternet_tpu_torch.serving.server`` processes on
    ``dev`` (several CUDA contexts on one card) behind the fleet router,
    driven closed-loop while ``gateway_crash`` kills worker 0 on its
    ``crash_at``-th request and ``gateway_hang`` wedges worker 1's loop on
    its ``hang_at``-th. Every 200 must be byte-identical to an unfaulted
    1-worker control fleet's answer; ``accounted`` reconciles the client's
    per-``X-Worker-Id`` ledger with the router's exactly."""
    import shutil
    import tempfile
    from pathlib import Path

    from waternet_tpu_torch.hub import init_state_dict
    from waternet_tpu_torch.serving import derive_buckets
    from waternet_tpu_torch.serving.fleet import FleetRouter
    from waternet_tpu_torch.serving.loadgen import run_load
    from waternet_tpu_torch.utils.checkpoint import save_weights

    n_images = _env_int("WATERNET_BENCH_FLEET_IMAGES", 24) if n_images is None else n_images
    max_batch = _env_int("WATERNET_BENCH_FLEET_BATCH", 4) if max_batch is None else max_batch
    max_buckets = _env_int("WATERNET_BENCH_SERVE_BUCKETS", 3) if max_buckets is None else max_buckets
    base = _env_int("WATERNET_BENCH_HW", 112) if base_hw is None else base_hw
    concurrency = (_env_int("WATERNET_BENCH_SERVE_CONCURRENCY", 2 * max_batch)
                   if concurrency is None else concurrency)
    n_req = _env_int("WATERNET_BENCH_SERVE_REQUESTS", 2 * n_images) if requests is None else requests
    crash_at = _env_int("WATERNET_BENCH_FLEET_CRASH_AT", 3) if crash_at is None else crash_at
    hang_at = crash_at + 2 if hang_at is None else hang_at
    warmup_budget = _env_int("WATERNET_BENCH_FLEET_WARMUP", 600)
    images, shapes = _serving_population(n_images, base)
    ladder = derive_buckets(shapes, max_buckets=max_buckets)
    payloads = _pngs(images)

    tmp = Path(tempfile.mkdtemp(prefix="waternet-fleet-bench-"))
    try:
        weights = save_weights(init_state_dict(0), tmp / "weights.npz")
        worker_cmd = [
            sys.executable, "-m", "waternet_tpu_torch.serving.server", "--device", dev.type,
            "--weights", str(weights), "--serve-buckets", ",".join(ladder.describe()),
            "--max-batch", str(max_batch), "--max-wait-ms", "5", "--serve-replicas", "1",
            "--max-queue", str(8 * max_batch),
        ]
        shared = dict(startup_grace_sec=float(warmup_budget), heartbeat_sec=0.25, poll_sec=0.05,
                      health_poll_sec=0.25, port=0)

        # Unfaulted 1-worker control fleet: the byte-identity reference,
        # through the router, so the relay itself must be byte-exact.
        router = FleetRouter(worker_cmd, n_workers=1, heartbeat_root=tmp / "control-hb", **shared)
        t0 = time.perf_counter()
        router.start_background()
        try:
            router.wait_ready(timeout=warmup_budget)
            warmup_s = time.perf_counter() - t0
            control = run_load(router.url, payloads, concurrency=1, total=len(payloads), keep_bodies=True)
        finally:
            router.request_drain()
            router.join()
        expected = {i: body for i, status, body in control["bodies"] if status == 200}

        faults = {(0, 0): f"gateway_crash@{crash_at}", (1, 0): f"gateway_hang@{hang_at}"}
        router = FleetRouter(
            worker_cmd, n_workers=workers, max_workers=workers + 1, worker_faults=faults,
            heartbeat_root=tmp / "chaos-hb", late_sec=2.0, hang_sec=4.0, drain_grace_sec=2.0,
            route_retries=workers, proxy_timeout_sec=60.0, slo="p99_ms<=500,error_rate<=0.05",
            slo_short_sec=5.0, slo_long_sec=20.0, slo_hold_sec=30.0, scale_cooldown_sec=5.0,
            backoff_base_sec=0.1, backoff_cap_sec=0.5, **shared,
        )
        t0 = time.perf_counter()
        router.start_background()
        try:
            router.wait_ready(timeout=warmup_budget, min_ready=workers)
            chaos_warmup_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            loaded = run_load(router.url, payloads, concurrency=concurrency, total=n_req, keep_bodies=True,
                              per_worker=True)
            chaos_s = time.perf_counter() - t0
            # Both faulted slots must come back as ready fresh generations.
            deadline = time.monotonic() + float(warmup_budget)
            recovered = False
            while time.monotonic() < deadline:
                fleet = router.summary()["fleet"]
                if fleet["ready"] >= workers and fleet["restarts"] >= 2:
                    recovered = True
                    break
                time.sleep(0.1)
            summary = router.summary()
        finally:
            router.request_drain()
            drain_rc = router.join()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    fleet = summary["fleet"]
    identity = len(expected) == len(payloads) and loaded["ok"] > 0 and all(
        body == expected[i % len(payloads)] for i, status, body in loaded["bodies"] if status == 200)
    # Exact two-sided per-worker reconciliation: a request served twice or
    # credited to the wrong generation breaks it from one side or the other.
    ledger, client_pw = fleet["per_worker"], loaded["per_worker"]
    pw_exact = all(
        ledger.get(wid, {}).get(key, 0) == bucket.get(key, 0)
        for wid, bucket in client_pw.items() if wid != "unattributed"
        for key in ("ok", "shed", "deadline_expired")
    ) and all(counts.get("ok", 0) == client_pw.get(wid, {}).get("ok", 0) for wid, counts in ledger.items())
    accounted = (pw_exact and loaded["errors"] == 0 and loaded["conn_reset"] == 0
                 and "unattributed" not in client_pw
                 and sum(c.get("ok", 0) for c in ledger.values()) == loaded["ok"])
    return {
        "metric": "fleet_images_per_sec",
        "value": loaded["ok"] / chaos_s if chaos_s else 0.0,
        "unit": "images/sec",
        "vs_baseline": None,
        "workers": workers,
        "faults": f"gateway_crash@{crash_at}(w0g0),gateway_hang@{hang_at}(w1g0)",
        "restarts": fleet["restarts"],
        "redispatches": fleet["redispatches"],
        "recovered": bool(recovered),
        "recovery_sec": fleet["recovery_sec_max"],
        "scale_events": fleet["scale_events"],
        "brownout": fleet["brownout"],
        "byte_identical": bool(identity),
        "accounted": bool(accounted),
        "per_worker": client_pw,
        "drained_clean": drain_rc == 0,
        "shed_count": loaded["shed"],
        "deadline_expired": loaded["deadline_expired"],
        "conn_reset": loaded["conn_reset"],
        "errors": loaded["errors"],
        "p99_ms": loaded["latency_ms"]["p99"],
        "buckets": ladder.describe(),
        "warmup_sec": warmup_s,
        "chaos_warmup_sec": chaos_warmup_s,
        "concurrency": concurrency,
        "requests": n_req,
        "n_images": n_images,
        "max_batch": max_batch,
        "device_kind": _device_kind(dev),
    }


def bench_stream(dev, n_images=None, max_batch=None, max_buckets=None, base_hw=None, streams=None,
                 frames=None) -> dict:
    """``video_stream_fps``: N paced concurrent ``POST /stream`` sessions
    over a two-tier server. A single unpaced calibration stream measures
    the frame capacity; phase A offers half of it split over
    ``WATERNET_BENCH_STREAMS`` (4) streams (its fps a stream is the value,
    its p99 frame latency is held against the freshness budget); phase B
    offers twice that, where the drop and brown-out rates say what the
    QoS machinery chose. ``accounted`` reconciles the client's per-frame
    ledger with the server's stream counters."""
    from waternet_tpu_torch.hub import init_state_dict
    from waternet_tpu_torch.inference_engine import InferenceEngine, StudentEngine
    from waternet_tpu_torch.serving import derive_buckets
    from waternet_tpu_torch.serving.loadgen import run_stream_load
    from waternet_tpu_torch.serving.server import ServingServer

    n_images, max_batch, max_buckets = _serving_env_defaults(n_images, max_batch, max_buckets)
    base = _env_int("WATERNET_BENCH_HW", 112) if base_hw is None else base_hw
    n_streams = _env_int("WATERNET_BENCH_STREAMS", 4) if streams is None else streams
    n_frames = _env_int("WATERNET_BENCH_STREAM_FRAMES", 12) if frames is None else frames
    images, shapes = _serving_population(n_images, base)
    ladder = derive_buckets(shapes, max_buckets=max_buckets)
    payloads = _pngs(images)
    engine = InferenceEngine(params=init_state_dict(0), device=dev)
    fast = StudentEngine(params=_student_params()[0], device=dev)
    server = ServingServer(
        engine, ladder, max_batch=max_batch, max_wait_ms=5.0, replicas=1,
        max_queue=8 * max_batch, admit_watermark=4 * max_batch, fast_engine=fast,
        downgrade_watermark=max(2, n_streams), max_streams=2 * n_streams, stream_window=4,
    )
    t0 = time.perf_counter()
    server.start_background()
    try:
        server.wait_ready()
        warmup_s = time.perf_counter() - t0
        cal = run_stream_load(server.url, payloads, streams=1, frames=2 * n_frames, fps=500.0,
                              budget_ms=60_000.0, window=64)
        cal_fps = max(1.0, cal["fps_per_stream"])
        real_time_fps = max(0.5, cal_fps / (2 * n_streams))
        budget_ms = 3000.0 / real_time_fps
        loaded = run_stream_load(server.url, payloads, streams=n_streams, frames=n_frames, fps=real_time_fps,
                                 budget_ms=budget_ms, tier="quality", allow_downgrade=True)
        overload = run_stream_load(server.url, payloads, streams=n_streams, frames=n_frames,
                                   fps=2 * real_time_fps, budget_ms=budget_ms, tier="quality",
                                   allow_downgrade=True)
    finally:
        server.request_drain()
        server.join()
    summary = server.stats.summary()
    st = summary["streams"]
    phases = (cal, loaded, overload)
    accounted = (
        st["frames_delivered"] == sum(p["ok"] for p in phases)
        and st["frames_dropped"] == sum(p["dropped"] for p in phases)
        and st["frames_out_of_budget"] == sum(p["out_of_budget"] for p in phases)
        and st["refused"] == sum(p["refused"] for p in phases)
        and all(p["errors"] == 0 and p["conn_reset"] == 0 and p["frame_errors"] == 0 for p in phases)
    )
    sent_2x = max(1, overload["frames_sent"])
    return {
        "metric": "video_stream_fps",
        "value": loaded["fps_per_stream"],
        "unit": "fps/stream",
        "vs_baseline": None,
        "streams": n_streams,
        "frames_per_stream": n_frames,
        "calibrated_fps": cal_fps,
        "offered_fps_per_stream": real_time_fps,
        "budget_ms": budget_ms,
        "p99_frame_ms": loaded["frame_latency_ms"]["p99"],
        "p99_within_budget": bool(loaded["frame_latency_ms"]["p99"] <= budget_ms),
        "drop_rate_at_2x": (overload["dropped"] + overload["out_of_budget"]) / sent_2x,
        "downgrade_rate_at_2x": overload["downgraded"] / sent_2x,
        "fps_per_stream_at_2x": overload["fps_per_stream"],
        "accounted": bool(accounted),
        "frames_delivered": st["frames_delivered"],
        "frames_dropped": st["frames_dropped"],
        "frames_out_of_budget": st["frames_out_of_budget"],
        "stream_downgrades": st["downgrades"],
        "streams_refused": st["refused"],
        "compiles": summary["compiles"],
        "cold_dispatches": engine.cold_dispatches + fast.cold_dispatches,
        "fallback_native_shapes": summary["fallback_native_shapes"],
        "buckets": ladder.describe(),
        "warmup_sec": warmup_s,
        "n_images": n_images,
        "max_batch": max_batch,
        "device_kind": _device_kind(dev),
    }


def bench_stream_reuse(dev, max_batch=None, max_buckets=None, base_hw=None, streams=None, frames=None,
                       static_pct=None) -> dict:
    """``stream_reuse_fps``: the same ``static_pct``-static synthetic
    streams (``WATERNET_BENCH_STATIC_PCT``, 75) served twice by one
    server, temporal reuse off then on, unpaced with a generous budget so
    nothing drops. The value is the reuse arm's effective fps a stream;
    ``effective_fps_multiplier`` is reuse on over off; both arms' delivered
    frames are scored with ``flicker_index`` (reuse replays the identical
    enhanced bytes for an identical input, so the delta stays in noise)."""
    import cv2

    from waternet_tpu_torch.hub import init_state_dict
    from waternet_tpu_torch.inference_engine import InferenceEngine
    from waternet_tpu_torch.metrics.flicker import flicker_index
    from waternet_tpu_torch.serving import derive_buckets
    from waternet_tpu_torch.serving.loadgen import _stream_payloads, run_stream_load
    from waternet_tpu_torch.serving.server import ServingServer

    _, max_batch, max_buckets = _serving_env_defaults(None, max_batch, max_buckets)
    base = _env_int("WATERNET_BENCH_HW", 112) if base_hw is None else base_hw
    n_streams = _env_int("WATERNET_BENCH_STREAMS", 4) if streams is None else streams
    n_frames = _env_int("WATERNET_BENCH_STREAM_FRAMES", 12) if frames is None else frames
    pct = _env_int("WATERNET_BENCH_STATIC_PCT", 75) if static_pct is None else static_pct
    shape = (base, base * 4 // 3)
    payloads = _stream_payloads(f"{shape[0]}x{shape[1]}", n=n_frames, static_pct=pct)
    ladder = derive_buckets([shape], max_buckets=max_buckets)
    engine = InferenceEngine(params=init_state_dict(0), device=dev)
    server = ServingServer(engine, ladder, max_batch=max_batch, max_wait_ms=5.0, replicas=1,
                           max_queue=8 * max_batch, admit_watermark=8 * max_batch, max_streams=2 * n_streams,
                           stream_window=8)
    t0 = time.perf_counter()
    server.start_background()
    try:
        server.wait_ready()
        warmup_s = time.perf_counter() - t0
        common = dict(streams=n_streams, frames=n_frames, fps=500.0, budget_ms=60_000.0, window=16,
                      keep_frames=True)
        control = run_stream_load(server.url, payloads, **common)
        reuse = run_stream_load(server.url, payloads, reuse_threshold=1.0, max_reuse_run=n_frames, **common)
    finally:
        server.request_drain()
        server.join()
    summary = server.stats.summary()
    st = summary["streams"]

    def mean_flicker(report):
        vals = []
        for recs in report.get("frames", {}).values():
            rgb = [cv2.imdecode(np.frombuffer(png, np.uint8), cv2.IMREAD_COLOR)[:, :, ::-1].astype(np.float32)
                   for _, _, png in sorted(recs)]
            if len(rgb) >= 2:
                vals.append(flicker_index(rgb))
        return float(np.mean(vals)) if vals else 0.0

    flicker_control, flicker_reuse = mean_flicker(control), mean_flicker(reuse)
    phases = (control, reuse)
    accounted = (
        st["frames_delivered"] == sum(p["ok"] for p in phases)
        and st["frames_reused"] == sum(p["reused"] for p in phases)
        and st["frames_dropped"] == sum(p["dropped"] for p in phases)
        and st["frames_out_of_budget"] == sum(p["out_of_budget"] for p in phases)
        and all(p["errors"] == 0 and p["conn_reset"] == 0 and p["frame_errors"] == 0 for p in phases)
    )
    control_fps = max(0.01, control["fps_per_stream"])
    return {
        "metric": "stream_reuse_fps",
        "value": reuse["fps_per_stream"],
        "unit": "fps/stream",
        "vs_baseline": reuse["fps_per_stream"] / control_fps,
        "effective_fps_multiplier": reuse["fps_per_stream"] / control_fps,
        "control_fps_per_stream": control["fps_per_stream"],
        "reuse_rate": reuse["reused"] / max(1, reuse["frames_sent"]),
        "frames_reused": reuse["reused"],
        "static_pct": pct,
        "streams": n_streams,
        "frames_per_stream": n_frames,
        "flicker_index_control": flicker_control,
        "flicker_index_reuse": flicker_reuse,
        "flicker_index_delta": flicker_reuse - flicker_control,
        "accounted": bool(accounted),
        "frames_delivered": st["frames_delivered"],
        "frames_dropped": st["frames_dropped"],
        "compiles": summary["compiles"],
        "cold_dispatches": engine.cold_dispatches,
        "buckets": ladder.describe(),
        "warmup_sec": warmup_s,
        "max_batch": max_batch,
        "device_kind": _device_kind(dev),
    }


def bench_train_chaos(dev, workers=2, epochs=3, n_images=8, batch=4, hw=32, kill_at=None, hang_at=None,
                      max_restarts=4, hang_sec=12.0, job_dir=None) -> dict:
    """``chaos_train_images_per_sec``: a supervised ``workers``-process
    data-parallel training job (``resilience/supervisor.py``, gloo between
    the ranks, each on the bench's ``--device``: several ranks share a
    card) with one worker killed hard (``proc_kill``, generation 0) and one
    hung without heartbeats (``proc_hang``, generation 1) mid-run, against
    an unfaulted control job. The value is the job's logical images over
    the chaos job's wall clock, restarts included; ``recovery_sec`` runs
    from failure detection to the next generation's first heartbeat,
    ``steps_lost`` is the work retrained from the last complete checkpoint,
    and ``exact_resume`` whether the chaos job's CSVs and final weights
    equal the control's byte for byte. CPU workers run one intra-op thread
    (two CPU processes may round otherwise); on CUDA, cuDNN's weight
    gradients are not deterministic, so ``exact_resume`` may read false
    there. ``WATERNET_BENCH_CHAOS_KILL_AT`` sets the kill's step."""
    import shutil
    import tempfile
    from pathlib import Path

    from waternet_tpu_torch.resilience.supervisor import Supervisor, SupervisorConfig

    kill_at = _env_int("WATERNET_BENCH_CHAOS_KILL_AT", 3) if kill_at is None else kill_at
    hang_at = kill_at + 2 if hang_at is None else hang_at
    owned = job_dir is None
    job = Path(tempfile.mkdtemp(prefix="waternet-train-chaos-") if owned else job_dir)
    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(repo), env.get("PYTHONPATH")) if p)
    if dev.type == "cpu":
        env["OMP_NUM_THREADS"] = "1"

    def _run(tag, faults):
        root = job / tag / "training"
        argv = [
            sys.executable, "-m", "waternet_tpu_torch.train", "--device", str(dev),
            "--synthetic", str(n_images), "--batch-size", str(batch),
            "--height", str(hw), "--width", str(hw), "--no-perceptual", "--precision", "fp32",
            "--epochs", str(epochs), "--checkpoint-every", "2", "--workers", "0", "--train-root", str(root),
        ]
        cfg = SupervisorConfig(
            num_workers=workers, max_restarts=max_restarts, backoff_base_sec=0.1, backoff_cap_sec=0.5,
            late_sec=max(1.0, hang_sec / 3), hang_sec=hang_sec, startup_grace_sec=600.0,
            drain_grace_sec=10.0, poll_sec=0.05, heartbeat_sec=0.0, cpu_gloo=True,
        )
        sup = Supervisor(argv, job / tag / "supervise", cfg, env=env, faults=faults)
        t0 = time.perf_counter()
        report = sup.run()
        return report, time.perf_counter() - t0, root

    def _final_run_dir(root):
        done = sorted((d for d in root.iterdir() if (d / "metrics-train.csv").is_file()),
                      key=lambda d: int(d.name)) if root.is_dir() else []
        return done[-1] if done else None

    try:
        ctl_report, ctl_s, ctl_root = _run("control", {})
        chaos_report, chaos_s, chaos_root = _run(
            "chaos", {(0, 1): f"proc_kill@{kill_at}", (1, 0): f"proc_hang@{hang_at}"})
        ctl_dir, chaos_dir = _final_run_dir(ctl_root), _final_run_dir(chaos_root)
        exact = ctl_dir is not None and chaos_dir is not None and all(
            (ctl_dir / f).read_bytes() == (chaos_dir / f).read_bytes()
            for f in ("metrics-train.csv", "metrics-val.csv", "last.npz"))
        gens = chaos_report["generations"]

        def _last(g):
            return max((w["last_step"] or 0 for w in g["workers"]), default=0)

        def _first(g):
            vals = [w["first_step"] for w in g["workers"] if w["first_step"]]
            return min(vals) if vals else None

        steps_lost = sum(max(0, _last(prev) - _first(nxt) + 1)
                         for prev, nxt in zip(gens, gens[1:]) if _first(nxt) is not None)
        recovery = chaos_report["recovery_sec"]
        n_val = max(1, min(90, n_images // 8))
        logical_images = epochs * (n_images - n_val)
        return {
            "metric": "chaos_train_images_per_sec",
            "value": logical_images / chaos_s if chaos_s else 0.0,
            "unit": "images/sec",
            "vs_baseline": None,
            "workers": workers,
            "faults": f"proc_kill@{kill_at}(gen0,rank1),proc_hang@{hang_at}(gen1,rank0)",
            "result": chaos_report["result"],
            "recovered": chaos_report["result"] == "completed" and ctl_report["result"] == "completed",
            "restarts": chaos_report["restarts"],
            "generations": len(gens),
            "recovery_sec": max(recovery) if recovery else None,
            "steps_lost": steps_lost,
            "exact_resume": bool(exact),
            "control_sec": ctl_s,
            "chaos_sec": chaos_s,
            "control_restarts": ctl_report["restarts"],
            "epochs": epochs,
            "n_images": n_images,
            "batch": batch,
            "hw": [hw, hw],
            "device_kind": _device_kind(dev),
        }
    finally:
        if owned:
            shutil.rmtree(job, ignore_errors=True)


#: The configs whose one line is one function of the device (streams, the
#: fleet, observability, multi-device serving, supervised training): the
#: function that makes each line (its ``metric`` is the JAX bench's contract
#: metric of the config).
SERVING_LINES = {
    "serve_adaptive": bench_serve_adaptive,
    "serve_chaos": bench_serving_chaos,
    "serve_fleet": bench_serving_fleet,
    "stream": bench_stream,
    "stream_reuse": bench_stream_reuse,
    "obs": bench_obs,
    "serve_multi": bench_serving_multi,
    "train_chaos": bench_train_chaos,
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="train",
                   choices=["train", "train_fullres", "video", "serve", "serve_http", "tiers", *SERVING_LINES,
                            *UNPORTED],
                   help="train (default: the three training lines), train_fullres (the 256x256 "
                   "device-cache codec A/B), video (1080p bf16 inference; WATERNET_QUANT=1: int8), "
                   "serve (bucketed vs exact-shape directory serving), serve_http (the HTTP front "
                   "door), tiers (the fast tier against the quality tier), serve_adaptive (fixed vs "
                   "adaptive coalescing), serve_chaos (replica faults under load), serve_fleet (the "
                   "fleet router over worker processes under gateway faults), stream (POST /stream "
                   "sessions), stream_reuse (temporal reuse off vs on), obs (the observability "
                   "stack's overhead), serve_multi (1 vs N replicas, one a card) or train_chaos (a "
                   "supervised 2-process training job under a kill and a hang).")
    p.add_argument("--batch-size", type=int, default=4, help="Frames a device batch (--config video).")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'.")
    args = p.parse_args(argv)
    if args.config in UNPORTED:
        print(f"bench --config {args.config} is not ported to waternet_tpu_torch yet "
              f"(ROADMAP {UNPORTED[args.config]})", file=sys.stderr)
        return 2
    if args.batch_size < 1:
        p.error("--batch-size must be >= 1")

    from waternet_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    if args.config == "video":
        quantize = os.environ.get("WATERNET_QUANT") == "1"
        print(json.dumps(bench_video(dev, args.batch_size, quantize=quantize)), flush=True)
        return 0
    if args.config == "train_fullres":
        print(json.dumps(bench_train_fullres(dev)), flush=True)
        return 0
    if args.config == "serve":
        print(json.dumps(bench_serving(dev)), flush=True)
        return 0
    if args.config == "serve_http":
        print(json.dumps(bench_serving_http(dev)), flush=True)
        return 0
    if args.config == "tiers":
        print(json.dumps(bench_tiers(dev)), flush=True)
        return 0
    if args.config in SERVING_LINES:
        print(json.dumps(SERVING_LINES[args.config](dev)), flush=True)
        return 0

    hostfed = os.environ.get("WATERNET_BENCH_HOSTFED", "1") != "0"
    cached = os.environ.get("WATERNET_BENCH_DEVICE_CACHE", "1") != "0"
    if not (hostfed or cached):
        raise SystemExit("WATERNET_BENCH_HOSTFED=0 and WATERNET_BENCH_DEVICE_CACHE=0 together disable every line")
    if hostfed:
        line = measure_train(dev, pipeline_ab=True)
        line["metric"] += "_hostfed"
        sync_fields = line.pop("hostfed_sync", None)
        if sync_fields is not None:
            ips = sync_fields.pop("pipeline_epoch_images_per_sec")
            print(json.dumps({
                "metric": "uieb_train_images_per_sec_per_chip_hostfed_sync",
                "value": ips, "unit": "images/sec/chip", "vs_baseline": ips / BASELINE_IMG_PER_SEC,
                **sync_fields, "batch": line["batch"], "hw": line["hw"], "precision": line["precision"],
            }), flush=True)
        print(json.dumps(line), flush=True)
    if cached:
        print(json.dumps(measure_train(dev, device_cache=True)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
