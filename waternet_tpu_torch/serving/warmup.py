"""Warmup: run every (bucket, batch[, replica]) shape once before serving.

The port of the JAX package's ``serving/warmup.py``. There, warmup
AOT-compiles one XLA executable per shape so that no request pays a
compile. Eager PyTorch has no compiler; what the first batch of a new
shape pays instead is cuDNN's execution plan and the caching allocator's
blocks. So warmup asks the engine for each shape's serving callable
(:meth:`InferenceEngine.warm_padded <waternet_tpu_torch.inference_engine.
InferenceEngine.warm_padded>`, which marks the shape warm) and runs one
probe batch through it, waiting for the result. Each such entry counts as
one ``stats.record_compile()``, so ``compiles`` is ``len(ladder) x
len(batch_sizes) x replicas``, as in the JAX package, and a bucketed
dispatch of a shape nobody warmed shows up as the engine's
``cold_dispatches`` (pinned at zero in tests/test_torch_serving.py).

A CUDA-graph capture of each entry is not part of this warmup: it is a
speed change, listed among ROADMAP's performance levers.
"""

from __future__ import annotations

import contextlib
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from waternet_tpu_torch.data.pipeline import THREAD_PREFIX
from waternet_tpu_torch.serving.bucketing import Bucket, BucketLadder
from waternet_tpu_torch.serving.stats import ServingStats
from waternet_tpu_torch.utils.tensor import ten2arr


def _cuda_stream(stream):
    import torch

    return torch.cuda.stream(stream)


def probe_image(bucket: Bucket) -> np.ndarray:
    """Deterministic uint8 probe canvas at exactly ``bucket`` shape, for
    warmup and for replica re-warm (docs/SERVING.md "Fault isolation"):
    after a quarantine, the supervisor pushes one probe batch through the
    replica's warmed callables; the exact-fit shape means zero pad work
    and a shape already warm. A fixed gradient rather than zeros, so the
    probe rides the same output-guard path real batches do without
    tripping the all-zero-canvas detector on degenerate weights."""
    bh, bw = bucket
    yy, xx = np.mgrid[0:bh, 0:bw]
    plane = ((yy * 3 + xx * 5) % 251).astype(np.uint8)
    return np.repeat(plane[..., None], 3, axis=-1)


def warmup(
    engine,
    ladder: BucketLadder,
    batch_sizes: Sequence[int],
    stats: Optional[ServingStats] = None,
    verbose: bool = False,
    replicas=None,
):
    """Warm the full (bucket x batch-size[, replica]) grid.

    Without ``replicas``: returns ``{((bh, bw), n): serve}`` for the
    engine's own placement. With ``replicas``, a list of ``(index, device,
    params, stream)`` from the pool (``stream`` the replica's CUDA stream,
    or None): returns ``{index: {((bh, bw), n): serve}}``, each grid bound
    to its replica's device and weights, each probe run on the replica's
    stream (whose allocator blocks the batches will reuse). Entries on one
    device warm one after another; distinct devices warm in parallel
    threads. Every entry counts once in ``stats`` (the ``compiles``
    field)."""
    sizes = sorted(set(int(b) for b in batch_sizes))
    if replicas is None:
        jobs = [(None, None, None, None, bucket, n) for bucket in ladder for n in sizes]
    else:
        jobs = [
            (index, device, params, stream, bucket, n)
            for (index, device, params, stream) in replicas
            for bucket in ladder
            for n in sizes
        ]

    def warm_one(job):
        index, device, params, stream, bucket, n = job
        t0 = time.perf_counter()
        serve = engine.warm_padded(n, bucket, device=device, params=params)
        on_stream = contextlib.nullcontext() if stream is None else _cuda_stream(stream)
        with on_stream:
            ten2arr(serve([probe_image(bucket)]))  # one probe batch, waited for
        if stats is not None:
            stats.record_compile()
        if verbose:
            bh, bw = bucket
            where = "" if index is None else f" on replica {index}"
            print(
                f"serving warmup: warmed {n}x{bh}x{bw}{where} in "
                f"{time.perf_counter() - t0:.1f}s"
            )
        return index, bucket, n, serve

    by_device: Dict[str, list] = {}
    for job in jobs:
        by_device.setdefault(str(engine._dev(job[1])), []).append(job)
    groups = list(by_device.values())
    if len(groups) == 1:
        results = [warm_one(j) for j in groups[0]]
    else:
        with ThreadPoolExecutor(
            max_workers=len(groups),
            thread_name_prefix=f"{THREAD_PREFIX}-serve-warmup",
        ) as pool:
            results = [r for rs in pool.map(lambda g: [warm_one(j) for j in g], groups) for r in rs]

    if replicas is None:
        return {(bucket, n): serve for _, bucket, n, serve in results}
    grids: Dict[int, Dict[Tuple[Bucket, int], object]] = {r[0]: {} for r in replicas}
    for index, bucket, n, serve in results:
        grids[index][(bucket, n)] = serve
    return grids
