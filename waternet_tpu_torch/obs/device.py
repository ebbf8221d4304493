"""Device-level gauge sources: peak TFLOP/s and device memory.

The torch counterpart of the JAX package's ``obs/device.py``: the
peak-FLOPs table the benchmark's MFU is computed against, and memory
gauges from ``torch.cuda``. Each returns None where the number is
unknowable (the CPU, an unlisted card), never a guess.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

# Peak TFLOP/s per card, by ``torch.cuda.get_device_name`` substring, from
# NVIDIA's H100 datasheet: dense BF16 on the tensor cores (the datasheet's
# figures with sparsity, halved), FP32 outside them (TF32 is off in the
# port) and dense INT8 TOP/s on the tensor cores (the int8 path's
# ``torch._int_mm``). The more specific names come first.
PEAK_TFLOPS_BY_NAME = (
    ("H100 PCIe", {"bf16": 756.5, "fp32": 51.0, "int8": 1513.0}),
    ("H100 80GB HBM3", {"bf16": 989.5, "fp32": 67.0, "int8": 1979.0}),  # SXM5
)

#: Overrides the table for any device, as in the JAX package.
PEAK_ENV = "WATERNET_TPU_PEAK_TFLOPS"


def peak_tflops(device, precision: str = "bf16") -> Optional[float]:
    """Peak TFLOP/s of ``device`` for ``precision`` ("bf16", "fp32" or
    "int8", the last in TOP/s), or
    None for the CPU and for a card the table does not list.
    ``WATERNET_TPU_PEAK_TFLOPS`` overrides the table."""
    env = os.environ.get(PEAK_ENV)
    if env:
        return float(env)
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    name = torch.cuda.get_device_name(dev)
    for sub, peaks in PEAK_TFLOPS_BY_NAME:
        if sub in name:
            return peaks[precision]
    return None


def hbm_peak_bytes(device) -> Optional[int]:
    """Peak bytes the caching allocator has handed out on ``device`` since
    the last ``torch.cuda.reset_peak_memory_stats``; None off CUDA."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(dev))


def hbm_limit_bytes(device) -> Optional[int]:
    """The card's total memory (``torch.cuda.mem_get_info``); None off CUDA."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(dev)[1])
