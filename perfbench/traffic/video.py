"""Video: batches of frames through an engine's ``enhance_async``, double
buffered as the port's video path runs them: batch k+1 is enqueued before
batch k is read back to uint8 on the host (``ten2arr``).

Mix keys: ``height``, ``width``, ``frames_per_call``, ``pool_calls``
(distinct batches made from the seed, sent in turn), ``warmup_calls``.
``frames_per_s`` is the frames read back in the window over its length.
"""

from __future__ import annotations

import time

import torch

from perfbench import arch as archs
from perfbench.harness import percentile
from perfbench.reference import compare
from perfbench.traffic import images
from perfbench.traffic.reservoir import Reservoir


def setup(run) -> dict:
    mix, cfg = run.mix, run.config
    arch = archs.load(cfg)
    params = arch.make_params(cfg, run.generator("weights"), run.device)
    run.mark("weights")
    b = mix["frames_per_call"]
    frames = images.frames(run.generator("frames"), mix["pool_calls"] * b, mix["height"], mix["width"],
                           run.device).cpu().numpy()
    calls = [frames[i * b:(i + 1) * b] for i in range(mix["pool_calls"])]
    run.mark("frames")
    engine = arch.engine(cfg, params, run.device, quantize=run.settings.get("quantize", False))
    run.mark("engine")
    from waternet_tpu_torch.utils.tensor import ten2arr

    for i in range(mix["warmup_calls"]):
        ten2arr(engine.enhance_async(calls[i % len(calls)]))
    run.mark("warmup")
    return {"arch": arch, "params": params, "calls": calls, "engine": engine}


def _stream(state, until, sample=None, enqueue_s=None, readback_s=None) -> int:
    """Run calls until ``until(calls enqueued)`` is true; returns how many
    calls were enqueued (and read back)."""
    from waternet_tpu_torch.obs import trace
    from waternet_tpu_torch.utils.tensor import ten2arr

    engine, calls = state["engine"], state["calls"]

    def enqueue(i):
        t = time.perf_counter()
        out = engine.enhance_async(calls[i % len(calls)])
        t1 = time.perf_counter()
        trace.record_span("enhance_async", "perfbench", t, t1)
        if enqueue_s is not None:
            enqueue_s.append(t1 - t)
        return out

    i, pending = 1, enqueue(0)
    while True:
        nxt = None if until(i) else enqueue(i)
        t = time.perf_counter()
        out = ten2arr(pending)
        t1 = time.perf_counter()
        trace.record_span("ten2arr", "perfbench", t, t1)
        if readback_s is not None:
            readback_s.append(t1 - t)
        if sample is not None:
            sample.offer((i - 1, out))
        if nxt is None:
            return i
        pending, i = nxt, i + 1


def window(run, state) -> dict:
    b = run.mix["frames_per_call"]
    sample = Reservoir(run.settings["check_calls"], run.rng("sample"))
    enqueue_s, readback_s = [], []
    t0 = run.start_window()
    n = _stream(state, lambda i: run.window_over(), sample, enqueue_s, readback_s)
    t1 = time.perf_counter()
    run.end_window(t1)
    state["sample"] = sample.items
    run.host.update(frames=n * b, window_s=t1 - t0, enqueue_s=enqueue_s,
                    frame_shape=(run.mix["height"], run.mix["width"]))
    if run.trace:
        run.start_profile()
        m = _stream(state, lambda i: run.profile_over(i * b))
        run.stop_profile(m * b)
    notes = {"enqueue_ms_p50": percentile(enqueue_s, 0.5) * 1e3, "readback_ms_p50": percentile(readback_s, 0.5) * 1e3,
             "readback_ms_p90": percentile(readback_s, 0.9) * 1e3}
    return {"attempted": n * b, "failed": 0, "metrics": {"frames_per_s": n * b / (t1 - t0)}, "notes": notes}


def close(run, state) -> None:
    state.pop("engine", None)
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def check(run, state) -> dict:
    """The sampled calls' frames against the reference on the same frames."""
    arch, cfg, params, calls = state["arch"], run.config, state["params"], state["calls"]
    pairs = []
    for i, out in state["sample"]:
        inp = calls[i % len(calls)]
        for j in range(len(inp)):
            want = arch.reference(cfg, params, torch.from_numpy(inp[j]).to(run.device))
            pairs.append((torch.from_numpy(out[j]), want))
    return compare.image_numbers(pairs)
