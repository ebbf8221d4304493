"""uint8 arrays <-> network-input tensors, NHWC (no permute: the public
layout is the JAX package's NHWC; the model permutes inside)."""

from __future__ import annotations

import numpy as np
import torch


def arr2ten(arr, device="cpu") -> torch.Tensor:
    """uint8 (N)HWC [0, 255] -> float32 NHWC [0, 1] on ``device``; adds the
    batch dim if absent."""
    ten = torch.as_tensor(np.asarray(arr)).to(device).to(torch.float32) / 255.0
    if ten.ndim == 3:
        ten = ten[None]
    return ten


def ten2arr(ten: torch.Tensor) -> np.ndarray:
    """float NHWC [0, 1] -> uint8 NHWC [0, 255] (clipped, truncated), as host
    numpy. The uint8 cast runs where the tensor lives, so a CUDA result
    crosses to the host at a quarter of the float bytes."""
    return (ten.detach().clamp(0.0, 1.0) * 255).to(torch.uint8).cpu().numpy()


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """Copy a host tensor to ``device`` without making the host wait for
    the device: to CUDA through pinned memory, asynchronously (a copy from
    pageable memory would wait for the stream's queued work)."""
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
