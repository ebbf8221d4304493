"""Where a device-preprocess request's time goes, on one CUDA card.

    python -m waternet_tpu_torch.stage_profile [--shape 4x1080x1920] [--reps 3]

Runs the stages of ``InferenceEngine(device_preprocess=True).enhance`` one
after another, as the engine runs them, with CUDA events between stages,
and prints one JSON line: the median device time of each stage, their sum,
the host-clock latency of the whole request, and, from ``torch.profiler``,
the device's busy and idle share over one request and its ten costliest
kernels. Weights are the committed trained fixture; frames are made from a
seed. Needs CUDA.
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


def _staged(engine, batch, events):
    """One request through the engine's device-preprocess stages, recording
    a CUDA event after each; returns the uint8 result."""

    def stamp(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((name, ev))

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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--shape", default="4x1080x1920", help="NxHxW of the request")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    n, h, w = (int(v) for v in args.shape.split("x"))

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

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.enhance(batch)
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

    medians = {k: statistics.median(v) for k, v in stage_ms.items()}
    print(json.dumps({
        "shape": [n, h, w],
        "card": gpu_card_line(),
        "stage_ms": medians,
        "stage_sum_ms": sum(medians.values()),
        "latency_ms": statistics.median(latency),
        "profiled_request": {
            "wall_ms": wall_us / 1e3,
            "device_busy_ms": busy_us / 1e3 if busy_us else None,
            "idle_share": 1.0 - busy_us / wall_us if busy_us else None,
            "top_kernels": [
                {"name": k[2][:90], "count": k[1], "device_ms": k[0] / 1e3} for k in kern[:10]
            ],
        },
    }))


if __name__ == "__main__":
    main()
