"""Serving: an open loop of Poisson arrivals from one generator thread into
``DynamicBatcher.submit``, in process, as ``waternet-serve`` builds its
batcher (one replica, the mix's bucket ladder, ``max_batch``,
``max_wait_ms`` and coalescing mode).

Mix keys: ``shapes`` (the population's native sizes), ``buckets``,
``max_batch``, ``max_wait_ms``, ``coalesce``, ``rate_per_s``, ``gap_seed``
and ``late_limit_s``. Every seed sends the same set of sizes and the same
set of gaps between arrivals (exponential, drawn once from ``gap_seed``),
in an order and with image content of its own. A request is timed from
when it was due on the schedule until its uint8 result is on the host, so
a stall that delays later submits counts in their latency; one that
fails, is shed, or is not done ``late_limit_s`` after the window closes
counts as failed. ``request_p95_ms`` is the 95th percentile over all
requests due in the window, failed ones ranked last.
"""

from __future__ import annotations

import math
import threading
import time

import numpy as np
import torch

from perfbench import arch as archs
from perfbench.harness import percentile
from perfbench.reference import compare
from perfbench.traffic import images


def bucket_for(buckets, h: int, w: int):
    """The smallest-area bucket covering (h, w)."""
    fits = [b for b in buckets if b[0] >= h and b[1] >= w]
    return min(fits, key=lambda b: (b[0] * b[1], b)) if fits else None


def schedule(mix: dict, seconds: float, seed_rng: np.random.Generator):
    """(due offsets in seconds, population index of each request)."""
    n = int(math.ceil(mix["rate_per_s"] * seconds * 1.5)) + 16
    gaps = np.random.default_rng(mix["gap_seed"]).exponential(1.0 / mix["rate_per_s"], n)
    dues = np.cumsum(seed_rng.permutation(gaps))
    dues = dues[dues < seconds]
    pop = len(mix["shapes"])
    order = np.concatenate([seed_rng.permutation(pop) for _ in range(len(dues) // pop + 1)])
    return dues, order[: len(dues)]


def setup(run) -> dict:
    from waternet_tpu_torch.serving import BucketLadder, DynamicBatcher

    mix, cfg = run.mix, run.config
    arch = archs.load(cfg)
    params = arch.make_params(cfg, run.generator("weights"), run.device)
    gen = run.generator("images")
    population = [images.frames(gen, 1, h, w, run.device)[0].cpu().numpy() for h, w in mix["shapes"]]
    run.mark("weights_and_images")
    engine = arch.engine(cfg, params, run.device, quantize=run.settings.get("quantize", False))
    run.mark("engine")
    batcher = DynamicBatcher(engine, BucketLadder([tuple(b) for b in mix["buckets"]]),
                             max_batch=mix["max_batch"], max_wait_ms=mix["max_wait_ms"],
                             replicas=1, coalesce=mix["coalesce"])
    run.mark("batcher_warmup")
    return {"arch": arch, "params": params, "population": population, "batcher": batcher}


def window(run, state) -> dict:
    mix, batcher, population = run.mix, state["batcher"], state["population"]
    total = run.seconds + (float(run.settings["profile_seconds"]) if run.trace else 0.0)
    dues, which = schedule(mix, total, np.random.default_rng(run.subseed("schedule")))
    in_window = int(np.searchsorted(dues, run.seconds))
    rng = run.rng("sample")
    sample = set(rng.sample(range(in_window), min(run.settings["check_requests"], in_window)))
    done = [None] * len(dues)
    kept, failed = {}, set()
    late = []

    def finished(i, fut):
        done[i] = time.perf_counter()
        if fut.exception() is not None:
            failed.add(i)
        elif i in sample:
            kept[i] = fut.result()

    stop = threading.Event()

    def generate():
        for i, due in enumerate(dues):
            if stop.is_set():
                return
            t_due = t0 + float(due)
            pause = t_due - time.perf_counter()
            if pause > 0:
                time.sleep(pause)
            late.append(time.perf_counter() - t_due)
            try:
                fut = batcher.submit(population[which[i]])
            except RuntimeError:  # QueueFull or DeadlineExpired: shed
                failed.add(i)
                done[i] = time.perf_counter()
                continue
            fut.add_done_callback(lambda f, i=i: finished(i, f))

    t0 = run.start_window()
    thread = threading.Thread(target=generate, name="perfbench-arrivals")
    thread.start()
    try:
        if run.trace:
            time.sleep(max(0.0, t0 + run.seconds - time.perf_counter()))
            run.start_profile()
            while not run.profile_over():
                time.sleep(0.05)
            run.stop_profile()
    except BaseException:
        stop.set()
        raise
    finally:
        thread.join()
    t_close = t0 + total
    while any(d is None for d in done) and time.perf_counter() < t_close + mix["late_limit_s"]:
        time.sleep(0.05)
    run.end_window(t0 + run.seconds)
    lat = []
    for i in range(in_window):
        if done[i] is None or i in failed:
            lat.append(math.inf)
        else:
            lat.append(done[i] - (t0 + float(dues[i])))
    n_failed = sum(1 for x in lat if x == math.inf)
    p95 = percentile(lat, 0.95)
    if not math.isfinite(p95):
        raise RuntimeError(f"{n_failed} of {in_window} requests failed: the 95th percentile is undefined")
    state.update(sample=kept, which=which, sampled=len(sample))
    run.host["batch_occupancy"] = batcher.stats.summary()["batch_occupancy"]
    third = max(1, in_window // 3)
    notes = {"requests": in_window, "late_ms_max": max(late) * 1e3 if late else 0.0,
             "late_ms_p50": percentile(late, 0.5) * 1e3 if late else 0.0,
             "p50_ms": percentile(lat, 0.5) * 1e3,
             "p50_first_third_ms": percentile(lat[:third], 0.5) * 1e3,
             "p50_last_third_ms": percentile(lat[-third:], 0.5) * 1e3}
    return {"attempted": in_window, "failed": n_failed, "metrics": {"request_p95_ms": p95 * 1e3},
            "notes": notes}


def close(run, state) -> None:
    batcher = state.pop("batcher", None)
    if batcher is not None:
        batcher.close()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def check(run, state) -> dict:
    """Each sampled request's result against the reference on the same
    image padded to its bucket, cropped back."""
    arch, cfg, params = state["arch"], run.config, state["params"]
    pairs = []
    for i, out in sorted(state["sample"].items()):
        img = state["population"][state["which"][i]]
        bucket = bucket_for(run.mix["buckets"], *img.shape[:2])
        pairs.append((torch.from_numpy(out), arch.reference_padded(cfg, params, img, bucket, run.device)))
    if not pairs or len(pairs) < state["sampled"]:
        return {}  # a sampled request never came: no number passes
    return compare.image_numbers(pairs)
