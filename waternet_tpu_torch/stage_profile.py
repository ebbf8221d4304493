"""Where a request's or a train step's time goes, on one CUDA card.

    python -m waternet_tpu_torch.stage_profile [--shape 4x1080x1920] [--reps 3]
    python -m waternet_tpu_torch.stage_profile --train [--shape 8x256x256] \
        [--precision fp32] [--codec dct8] [--precache] [--reps 3]

Inference: runs the stages of ``InferenceEngine(device_preprocess=True).
enhance`` one after another, as the engine runs them, with CUDA events
between stages. Weights are the committed trained fixture; frames are made
from a seed. ``--train``: one cached train step of ``TrainingEngine``,
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
from waternet_tpu_torch.ops.clahe import clahe
from waternet_tpu_torch.ops.color import lab_u8_to_rgb, rgb_to_lab_u8
from waternet_tpu_torch.ops.gamma import gamma_correction
from waternet_tpu_torch.ops.wb import white_balance
from waternet_tpu_torch.utils.device import gpu_card_line
from waternet_tpu_torch.utils.synthetic import photo_frames
from waternet_tpu_torch.utils.tensor import ten2arr

WEIGHTS = Path(__file__).resolve().parent.parent / "tests/fixtures/distill/teacher.npz"


def _event_stamp(events):
    """A stage hook that records a CUDA event under the stage's name."""

    def stamp(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((name, ev))

    return stamp


def _staged(engine, batch, events):
    """One request through the engine's device-preprocess stages, recording
    a CUDA event after each; returns the uint8 result."""
    stamp = _event_stamp(events)
    stamp("start")
    rgb = torch.as_tensor(batch).to(engine.device)
    stamp("upload")
    wb = white_balance(rgb)
    stamp("white_balance")
    gc = gamma_correction(rgb)
    stamp("gamma")
    lab = rgb_to_lab_u8(rgb)
    stamp("lab_forward")
    el = clahe(lab[..., 0])
    stamp("clahe")
    he = lab_u8_to_rgb(torch.cat([el[..., None], lab[..., 1:]], dim=-1))
    stamp("lab_inverse")
    x = rgb.to(torch.float32) / 255.0
    out = engine.model(x, wb / 255.0, he / 255.0, gc / 255.0)
    stamp("forward")
    res = ten2arr(out)
    stamp("download")
    return res


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

    engine = InferenceEngine(weights=WEIGHTS, device_preprocess=True)
    batch = photo_frames(np.random.default_rng(0), n, h, w)
    want = engine.enhance(batch)  # warm-up, and the reference output

    stage_ms: dict[str, list[float]] = {}
    latency = []
    with torch.inference_mode():
        for _ in range(args.reps):
            events = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = _staged(engine, batch, events)
            latency.append((time.perf_counter() - t0) * 1e3)
            diff = np.abs(got.astype(np.int16) - want.astype(np.int16)).max()
            if diff > 1:
                raise SystemExit(f"staged request differs from enhance() by {diff}")
            for (_, a), (name, b) in zip(events, events[1:]):
                stage_ms.setdefault(name, []).append(a.elapsed_time(b))

    medians = {k: statistics.median(v) for k, v in stage_ms.items()}
    print(json.dumps({
        "shape": [n, h, w],
        "card": gpu_card_line(),
        "stage_ms": medians,
        "stage_sum_ms": sum(medians.values()),
        "latency_ms": statistics.median(latency),
        "profiled_request": _profile(lambda: engine.enhance(batch)),
    }))


if __name__ == "__main__":
    main()
