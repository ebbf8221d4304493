"""uint8 arrays <-> network-input tensors, NHWC (no permute: the public
layout is the JAX package's NHWC; the model permutes inside)."""

from __future__ import annotations

import threading

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
    pageable memory would wait for the stream's queued work). A tensor
    already on a CUDA device is moved as is."""
    device = torch.device(device)
    if device.type != "cuda" or t.is_cuda:
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class DeviceFeeder:
    """Host-to-device copies made on pipeline worker threads, overlapping
    the step that runs on the consumer's stream.

    :meth:`send` (worker side) copies host arrays through pinned memory on
    a CUDA stream of the calling thread's own, ``non_blocking``, records
    an event and waits for it, so the worker's transfer stage times the
    copy and the consumer never does. A copy from pageable memory would
    block the host, and one on the default stream would serialise with the
    step. Pinned buffers come from PyTorch's caching host allocator, which
    reuses a buffer only once its copy's event has completed.

    :meth:`receive` (consumer side) makes the current stream wait on that
    event and marks each tensor as used by it (``record_stream``), so the
    caching allocator does not hand the tensor's memory back to the copy
    stream while the step still reads it. On the CPU nothing is copied:
    the tensors share the arrays' memory.
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self._local = threading.local()

    def send(self, arrays):
        """numpy arrays -> (tensors on the device, the copy's event or None)."""
        host = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        if self.device.type != "cuda":
            return host, None
        stream = getattr(self._local, "stream", None)
        if stream is None:
            stream = self._local.stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(stream):
            out = [t.pin_memory().to(self.device, non_blocking=True) for t in host]
            event = torch.cuda.Event()
            event.record(stream)
        event.synchronize()
        return out, event

    def receive(self, sent):
        """What :meth:`send` returned -> tensors the current stream may use."""
        tensors, event = sent
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in tensors:
                t.record_stream(stream)
        return tensors
