"""Where a request's or a train step's time goes, on one CUDA card.

    python -m waternet_tpu_torch.stage_profile [--shape 4x1080x1920] [--precision bf16] [--reps 3]
    python -m waternet_tpu_torch.stage_profile --train [--shape 8x256x256] \
        [--precision fp32] [--codec dct8] [--precache] [--reps 3]

Inference: ``InferenceEngine(device_preprocess=True).enhance`` with the
trace recorder armed, so the stages are the engine's own spans
(``engine.upload``, ``engine.preprocess``, ``engine.forward``,
``readback.wait``, ``readback.copy``; ``obs/stages.py``) and their device
time comes from the CUDA events the engine records around each (the
readback's: its uint8 cast; the copy into pageable memory has none);
``--precision bf16`` gives the engine bf16 autocast. Weights are the
committed trained fixture; frames are made from a seed. The profiler's
kernel names (``profiled_request``) split the preprocessing further.
``--train``: one cached train step of ``TrainingEngine``,
the engine's own, with a CUDA event at each of its stage hooks (gather
and decode, preprocess, forward, losses, backward, optimizer, metrics),
perceptual loss on, over ``SyntheticPairs`` (seed 0) after a warm-up
epoch; ``--precache`` (raw codec) times the cached-pre step over the
precache tables, whose ``preprocess`` stage is the augment and the
table gathers. Either prints one JSON line: the median
device time of each stage, their sum, the host-clock time of the whole
request or step, and, from ``torch.profiler``, the device's busy and idle
share over one more and its ten costliest kernels. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path

import numpy as np
import torch

from waternet_tpu_torch.inference_engine import InferenceEngine
from waternet_tpu_torch.obs import trace
from waternet_tpu_torch.obs.stages import CAT
from waternet_tpu_torch.utils.device import gpu_card_line
from waternet_tpu_torch.utils.synthetic import photo_frames

WEIGHTS = Path(__file__).resolve().parent.parent / "tests/fixtures/distill/teacher.npz"


def _event_stamp(events):
    """A stage hook that records a CUDA event under the stage's name."""

    def stamp(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((name, ev))

    return stamp


def engine_stages(engine, batch, reps: int) -> tuple:
    """``reps`` calls of ``engine.enhance(batch)`` with the process's trace
    recorder armed (reset before each; disarmed and reset after) ->
    ({stage: [device ms]}, {stage: [host ms]}, [call ms]): each of the
    engine's and the readback's spans, the device lists holding the stages
    that carry ``device_ms`` (none on the CPU)."""
    rec = trace.recorder()
    device_ms: dict[str, list[float]] = {}
    host_ms: dict[str, list[float]] = {}
    calls = []
    try:
        for _ in range(reps):
            rec.reset()
            rec.enable()
            t0 = time.perf_counter()
            engine.enhance(batch)
            calls.append((time.perf_counter() - t0) * 1e3)
            rec.disable()
            for name, cat, ph, _, dur, _, args in rec.snapshot()[0]:
                if cat != CAT or ph != "X":
                    continue
                host_ms.setdefault(name, []).append(dur * 1e3)
                if args and "device_ms" in args:
                    device_ms.setdefault(name, []).append(args["device_ms"])
    finally:
        rec.disable()
        rec.reset()
    return device_ms, host_ms, calls


def _profile(fn) -> dict:
    """Device busy and idle share over one call of ``fn``, and its ten
    costliest device-side events, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = []  # device-side events only (kernels, copies): no double count
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            kern.append((dev_us, e.count, e.key))
    kern.sort(reverse=True)
    busy_us = sum(k[0] for k in kern)
    return {
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3 if busy_us else None,
        "idle_share": 1.0 - busy_us / wall_us if busy_us else None,
        "top_kernels": [
            {"name": k[2][:90], "count": k[1], "device_ms": k[0] / 1e3} for k in kern[:10]
        ],
    }


def train_main(args) -> None:
    from waternet_tpu_torch.data.synthetic import SyntheticPairs
    from waternet_tpu_torch.training.trainer import TrainConfig, TrainingEngine, step_generator

    n, h, w = (int(v) for v in args.shape.split("x"))
    cfg = TrainConfig(batch_size=n, im_height=h, im_width=w, precision=args.precision,
                      cache_codec=args.codec, precache_histeq=args.precache)
    engine = TrainingEngine(cfg)
    engine.cache_dataset(SyntheticPairs(4 * n, h, w, seed=0), np.arange(4 * n))
    engine.train_epoch_cached(0)  # warm-up: cuDNN's algorithm search
    idx = torch.arange(n, device=engine.device)
    step_fn, cache_args = engine.cached_train_step()

    stage_ms: dict[str, list[float]] = {}
    step = []
    for rep in range(args.reps):
        events = []
        stamp = _event_stamp(events)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stamp("start")
        step_fn(*cache_args, idx, step_generator(0, 1, rep), n, stamp=stamp)
        torch.cuda.synchronize()
        step.append((time.perf_counter() - t0) * 1e3)
        for (_, a), (name, b) in zip(events, events[1:]):
            stage_ms.setdefault(name, []).append(a.elapsed_time(b))
    medians = {k: statistics.median(v) for k, v in stage_ms.items()}
    print(json.dumps({
        "train_step": [n, h, w], "precision": args.precision, "codec": args.codec,
        "precache": engine._cache_pre is not None,
        "card": gpu_card_line(),
        "stage_ms": medians,
        "stage_sum_ms": sum(medians.values()),
        "step_ms": statistics.median(step),
        "profiled_step": _profile(
            lambda: step_fn(*cache_args, idx, step_generator(0, 2, 0), n)
        ),
    }))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--shape", help="NxHxW of the request (default 4x1080x1920) "
                    "or of the train batch (default 8x256x256)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--train", action="store_true", help="profile a cached train step")
    ap.add_argument("--precision", default="fp32", choices=["fp32", "bf16"])
    ap.add_argument("--codec", default="dct8", choices=["raw", "yuv420", "dct8"])
    ap.add_argument("--precache", action="store_true",
                    help="with --codec raw: build the precache tables and time the cached-pre step")
    args = ap.parse_args(argv)
    if args.train:
        args.shape = args.shape or "8x256x256"
        return train_main(args)
    n, h, w = (int(v) for v in (args.shape or "4x1080x1920").split("x"))

    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    engine = InferenceEngine(weights=WEIGHTS, device_preprocess=True, dtype=dtype)
    batch = photo_frames(np.random.default_rng(0), n, h, w)
    engine.enhance(batch)  # warm-up
    torch.cuda.synchronize()
    device_ms, host_ms, calls = engine_stages(engine, batch, args.reps)
    medians = {k: statistics.median(v) for k, v in device_ms.items()}
    print(json.dumps({
        "shape": [n, h, w],
        "precision": args.precision,
        "card": gpu_card_line(),
        "stage_ms": medians,
        "stage_sum_ms": sum(medians.values()),
        "stage_host_ms": {k: statistics.median(v) for k, v in host_ms.items()},
        "latency_ms": statistics.median(calls),
        "profiled_request": _profile(lambda: engine.enhance(batch)),
    }))


if __name__ == "__main__":
    main()
