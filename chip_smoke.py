#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``waternet_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py            # from the repository root; needs 1 card

Phases; any failure exits non-zero, and nothing below is caught:

1. the card's name and power limit (nvidia-smi), and the TF32 switches;
2. build the CLAHE kernels from ``waternet_tpu_torch/csrc`` with nvcc;
3. each kernel against its plain PyTorch version on the card, bit for
   bit, at the main-path shape (4 x 1080x1920) and an odd one (1 x
   723x1001), with its time, its plain version's time, the one-call
   PyTorch yardstick where there is one, and its bound;
4. CLAHE through the kernels against the plain CLAHE, bit for bit;
5. the main path, ``InferenceEngine(device_preprocess=True)`` on CUDA with
   the committed trained weights, answering R1 (4 x 1080x1920, batched
   1080p video frames), R2 (1 x 723x1001) and R3 (2 x 251x333), with both
   kernels' launch counters read around that run; R3 again on the CPU
   port, which must agree within one uint8 level.

The last lines are the ``{"kernels": [...]}`` summary, the card line and
the ``{"ok": true, "device": ...}`` result. Inputs are smooth random
fields plus noise, made with numpy from a seed
(``waternet_tpu_torch.utils.synthetic``).
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

SEED = 0
WEIGHTS = str(Path(__file__).resolve().parent / "tests" / "fixtures" / "distill" / "teacher.npz")
KERNEL_SOURCE = "waternet_tpu_torch/csrc/clahe.cu"
# H100 SXM data sheet: 3.35 TB/s of HBM3 (at the full 700 W limit).
HBM_BYTES_PER_S = 3.35e12
REPLACES = {
    "tile_lut": "waternet_tpu/ops/pallas_kernels.py:133",
    "clahe_lut_planes": "waternet_tpu/ops/pallas_kernels.py:229",
}
KERNEL_SHAPES = {"main": (4, 1080, 1920), "odd": (1, 723, 1001)}
REQUESTS = {"R1": (4, 1080, 1920), "R2": (1, 723, 1001), "R3": (2, 251, 333)}
TIMING_REPS = 25


def device_ms(torch, fn, flush) -> float:
    """Median device time of ``fn`` over TIMING_REPS runs after warm-up,
    by CUDA events. Each run starts with a cold L2 (``flush`` overwrites a
    buffer larger than it) behind a spin kernel long enough for the host to
    enqueue the whole run, so host overhead is not timed."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMING_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        flush.zero_()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAIL: {msg}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is False", file=sys.stderr)
        return 2

    from waternet_tpu_torch.inference_engine import InferenceEngine
    from waternet_tpu_torch.ops import _build, kernels
    from waternet_tpu_torch.ops.clahe import clahe, clahe_inputs
    from waternet_tpu_torch.ops.color import rgb_to_lab_u8
    from waternet_tpu_torch.utils.device import gpu_card_line, resolve_device
    from waternet_tpu_torch.utils.synthetic import photo_frames

    rng = np.random.default_rng(SEED)

    # 1. Card and numerics.
    dev = resolve_device("cuda")
    card = gpu_card_line()
    print(f"card: {card}", flush=True)
    tf32 = {
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
        "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
    }
    print(f"tf32: {json.dumps(tf32)}", flush=True)
    check(not any(tf32.values()), f"TF32 must be off: {tf32}")

    # 2. Build.
    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s ({_build.ARCH})", flush=True)
    ptxas = (_build.BUILD_DIR / (_build.LIB_NAME + ".log"))
    if ptxas.is_file():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"ptxas: {line.strip()}", flush=True)

    # 3. Kernels against their plain versions, on the card.
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    ty, tx = 8, 8
    summary = {}
    for tag, (n, h, w) in KERNEL_SHAPES.items():
        rgb = torch.from_numpy(photo_frames(rng, n, h, w)).to(dev)
        lum = rgb_to_lab_u8(rgb)[..., 0].to(torch.uint8)
        l_pad, clip, scale, g = clahe_inputs(lum, tile_grid=(ty, tx))
        hp, wp = l_pad.shape[1:]
        th, tw = g["tile"]
        idx = (*g["y"], *g["x"])

        luts_k = kernels.tile_lut(l_pad, (ty, tx), clip, scale)
        luts_p = kernels.tile_lut_plain(l_pad, (ty, tx), clip, scale)
        planes_k = kernels.clahe_lut_planes(luts_p, l_pad, *idx)
        planes_p = kernels.clahe_lut_planes_plain(luts_p, l_pad, *idx)
        torch.cuda.synchronize()
        err_lut = (luts_k - luts_p).abs().max().item()
        err_planes = (planes_k - planes_p).abs().max().item()
        check(torch.equal(luts_k, luts_p), f"tile_lut != plain at {tag} {n}x{h}x{w}")
        check(
            torch.equal(planes_k, planes_p),
            f"clahe_lut_planes != plain at {tag} {n}x{h}x{w}",
        )

        # Yardstick: the four quadrant gathers as one PyTorch indexing call.
        img = torch.arange(n, device=dev)[None, :, None, None]
        yq = torch.stack([idx[0], idx[0], idx[1], idx[1]]).long()[:, None, :, None]
        xq = torch.stack([idx[2], idx[3], idx[2], idx[3]]).long()[:, None, None, :]
        v = l_pad.long()[None]
        check(torch.equal(luts_p[img, yq, xq, v], planes_p), "yardstick gather differs")

        lut_bytes = n * ty * tx * 256 * 4
        idx_bytes = 2 * (hp + wp) * 4
        rows = {
            "tile_lut": {
                "ms": device_ms(torch, lambda: kernels.tile_lut(l_pad, (ty, tx), clip, scale), flush),
                "plain_ms": device_ms(
                    torch, lambda: kernels.tile_lut_plain(l_pad, (ty, tx), clip, scale), flush
                ),
                "library_ms": None,
                "bytes": n * hp * wp + lut_bytes,
                "max_abs_err": err_lut,
            },
            "clahe_lut_planes": {
                "ms": device_ms(torch, lambda: kernels.clahe_lut_planes(luts_p, l_pad, *idx), flush),
                "plain_ms": device_ms(
                    torch, lambda: kernels.clahe_lut_planes_plain(luts_p, l_pad, *idx), flush
                ),
                "library_ms": device_ms(torch, lambda: luts_p[img, yq, xq, v], flush),
                "bytes": lut_bytes + n * hp * wp + idx_bytes + 4 * n * hp * wp * 4,
                "max_abs_err": err_planes,
            },
        }
        for name, r in rows.items():
            r["bound_ms"] = r["bytes"] / HBM_BYTES_PER_S * 1e3
            line = {
                "kernel": name, "shape": tag, "n": n, "h": h, "w": w,
                "padded": [hp, wp], "tile": [th, tw],
                "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
                "library_ms": r["library_ms"], "bound_ms": r["bound_ms"],
                "bytes": r["bytes"], "max_abs_err": r["max_abs_err"],
                "bit_identical": True, "card": card,
            }
            print(json.dumps(line), flush=True)
            if tag == "main":
                summary[name] = r
        del luts_k, planes_k, planes_p

        # 4. CLAHE through the kernels == the plain CLAHE.
        got = clahe(lum, use_kernels=True)
        want = clahe(lum, use_kernels=False)
        check(torch.equal(got, want), f"clahe(kernels) != clahe(plain) at {tag}")
        print(f"clahe {tag} {n}x{h}x{w}: kernels == plain, bit for bit", flush=True)

    # 5. The main path answers requests.
    engine = InferenceEngine(weights=WEIGHTS, device_preprocess=True)
    batches = {k: photo_frames(rng, *shape) for k, shape in REQUESTS.items()}
    for b in batches.values():  # warm-up: one call per request shape
        engine.enhance(b)
    torch.cuda.synchronize()

    kernels.reset_launches()
    outs = {}
    for name, batch in batches.items():
        before = dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = engine.enhance(batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        grew = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        check(all(d == 1 for d in grew.values()), f"{name}: launches {grew}, want 1 each")
        check(out.dtype == np.uint8 and out.shape == batch.shape, f"{name}: output {out.dtype} {out.shape}")
        outs[name] = out
        print(json.dumps({
            "request": name, "shape": list(batch.shape), "latency_ms": dt * 1e3,
            "frames_per_s": len(batch) / dt, "launches": grew, "card": card,
        }), flush=True)
    launches = dict(kernels.LAUNCHES)
    check(all(c == len(REQUESTS) for c in launches.values()), f"main path launches {launches}")

    # Steady-state R1 latency (outside the counted run).
    torch.cuda.reset_peak_memory_stats()
    lat = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.enhance(batches["R1"])
        lat.append(time.perf_counter() - t0)
    p50 = statistics.median(lat)
    print(json.dumps({
        "request": "R1 x5", "latency_ms_p50": p50 * 1e3, "latency_ms": [t * 1e3 for t in lat],
        "frames_per_s": REQUESTS["R1"][0] / p50,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(), "card": card,
    }), flush=True)

    # R3 on the CPU port: within one uint8 level.
    cpu = InferenceEngine(weights=WEIGHTS, device_preprocess=True, device="cpu")
    ref = cpu.enhance(batches["R3"])
    diff = np.abs(ref.astype(np.int16) - outs["R3"].astype(np.int16))
    print(json.dumps({
        "R3_vs_cpu": {"max_abs_diff": int(diff.max()), "share_differing": float((diff > 0).mean())},
    }), flush=True)
    check(diff.max() <= 1, f"R3 differs from the CPU port by {diff.max()} levels")
    for name, out in outs.items():
        check(out.std() > 0, f"{name}: constant output")

    kernels_line = []
    for name, r in summary.items():
        kernels_line.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": "bytes", "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(card, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
