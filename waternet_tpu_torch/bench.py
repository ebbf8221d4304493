"""The port's benchmark: training images and video frames per second on one card.

    python -m waternet_tpu_torch.bench                          # three lines
    python -m waternet_tpu_torch.bench --config train_fullres
    python -m waternet_tpu_torch.bench --config video [--batch-size 4]
    python -m waternet_tpu_torch.bench --config serve
    python -m waternet_tpu_torch.bench --config serve_http
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
int8 arm) exits 2: the int8 path is Queue A item 7.

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
caught: the run exits non-zero without a last line. Other ``--config``
names of the JAX bench exit with status 2 and the ROADMAP item that
ports their modules.
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

#: The JAX bench's other configs, and the ROADMAP item that ports what they drive.
UNPORTED = {
    **{name: "Queue A item 6, its next part (streams, fleet, the adaptive and chaos A/Bs)"
       for name in ("serve_adaptive", "serve_chaos", "serve_fleet", "stream", "stream_reuse", "obs")},
    "serve_multi": "Queue A item 8 (multi-GPU)",
    "tiers": "Queue A item 7 (fast tier)",
    "train_chaos": "Queue A items 5 (resilience) and 8 (its supervisor needs multi-GPU)",
}


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


def bench_video(dev, batch: int = 4) -> dict:
    """The video line: double-buffered bf16 enhancement of ``batch``
    1080p frames a call, upload and uint8 readback included."""
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
                             dtype=torch.bfloat16)
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
    peak = peak_tflops(dev, "bf16")
    return {
        "metric": "video_1080p_frames_per_sec_per_chip",
        "value": fps,
        "unit": "frames/sec/chip",
        "vs_baseline": None,
        "batch": batch,
        "frame_ms": dt / (batch * steps) * 1e3,
        "quantized": False,
        "mfu": fps * waternet_forward_flops(h, w) / 1e12 / peak if peak else None,
        "hbm_peak_bytes": hbm_peak_bytes(dev),
        "peak_tflops_assumed": peak,
        "device_kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
        "hw": [h, w],
        "precision": "bf16",
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


def bench_serving_http(dev, n_images=None, max_batch=None, max_buckets=None, base_hw=None,
                       concurrency=None, requests_per_phase=None) -> dict:
    """``http_images_per_sec``: the front door end to end over sockets, in
    three phases (serial, closed loop, 2x overload against a tight
    watermark), with the accounting cross-checked against the server."""
    import cv2

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
    payloads = [cv2.imencode(".png", im[:, :, ::-1])[1].tobytes() for im in images]
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="train",
                   choices=["train", "train_fullres", "video", "serve", "serve_http", *UNPORTED],
                   help="train (default: the three training lines), train_fullres (the 256x256 "
                   "device-cache codec A/B), video (1080p bf16 inference), serve (bucketed vs "
                   "exact-shape directory serving) or serve_http (the HTTP front door); the JAX "
                   "bench's other configs are not ported yet.")
    p.add_argument("--batch-size", type=int, default=4, help="Frames a device batch (--config video).")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'.")
    args = p.parse_args(argv)
    if args.config in UNPORTED:
        print(f"bench --config {args.config} is not ported to waternet_tpu_torch yet "
              f"(ROADMAP {UNPORTED[args.config]})", file=sys.stderr)
        return 2
    if args.config == "video" and os.environ.get("WATERNET_QUANT") == "1":
        print("bench --config video with WATERNET_QUANT=1: the int8 path is not ported to "
              "waternet_tpu_torch yet (ROADMAP Queue A item 7, fast tier)", file=sys.stderr)
        return 2
    if args.batch_size < 1:
        p.error("--batch-size must be >= 1")

    from waternet_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    if args.config == "video":
        print(json.dumps(bench_video(dev, args.batch_size)), flush=True)
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
