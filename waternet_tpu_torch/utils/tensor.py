"""uint8 arrays <-> network-input tensors, NHWC (no permute: the public
layout is the JAX package's NHWC; the model permutes inside)."""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from waternet_tpu_torch.obs import stages, trace


def arr2ten(arr, device="cpu") -> torch.Tensor:
    """uint8 (N)HWC [0, 255] -> float32 NHWC [0, 1] on ``device``; adds the
    batch dim if absent."""
    ten = torch.as_tensor(np.asarray(arr)).to(device).to(torch.float32) / 255.0
    if ten.ndim == 3:
        ten = ten[None]
    return ten


def _to_u8(ten: torch.Tensor) -> torch.Tensor:
    return (ten.detach().clamp(0.0, 1.0) * 255).to(torch.uint8)


def ten2arr(ten: torch.Tensor) -> np.ndarray:
    """float NHWC [0, 1] -> uint8 NHWC [0, 255] (clipped, truncated), as host
    numpy. The uint8 cast runs where the tensor lives, so a CUDA result
    crosses to the host at a quarter of the float bytes.

    With the trace recorder armed, records ``readback.wait`` (until the
    device has finished the cast, with the cast's ``device_ms``) and
    ``readback.copy`` (the copy to the host and ``.numpy()``), then lands
    the pending stage spans the device has passed. The copy is left out of
    the device bracket: into pageable memory it goes at the host's pace,
    so an event after it would count the host's page faults as device
    time (the profiler's ``Memcpy DtoH`` times it)."""
    if not trace.enabled():
        return _to_u8(ten).cpu().numpy()
    t0 = time.perf_counter()
    args = {"frames": ten.shape[0] if ten.dim() == 4 else 1}
    start = stages.device_event(ten.device)
    u8 = _to_u8(ten)
    cast = stages.device_event(ten.device)
    if cast is not None:
        cast.synchronize()  # where .cpu() would wait anyway
        args["device_ms"] = start.elapsed_time(cast)
    t1 = time.perf_counter()
    trace.record_span("readback.wait", stages.CAT, t0, t1, args=args)
    out = u8.cpu().numpy()
    trace.record_span("readback.copy", stages.CAT, t1, time.perf_counter(),
                      args={"frames": args["frames"], "bytes": out.nbytes})
    trace.resolve_pending()
    return out


def to_device(t: torch.Tensor, device, before_copy=None) -> torch.Tensor:
    """Copy a host tensor to ``device`` without making the host wait for
    the device: to CUDA through pinned memory, asynchronously (a copy from
    pageable memory would wait for the stream's queued work). A tensor
    already on a CUDA device is moved as is. ``before_copy(device)``, if
    given, is called once the host's staging is done, right before the
    copy is enqueued (the engine's stage timing starts there)."""
    device = torch.device(device)
    if device.type != "cuda" or t.is_cuda:
        if before_copy is not None:
            before_copy(device)
        return t.to(device)
    t = t.pin_memory()
    if before_copy is not None:
        before_copy(device)
    return t.to(device, non_blocking=True)


def start_readback(t: torch.Tensor):
    """Enqueue a copy of ``t`` to host memory on the current stream and
    return ``(host tensor, event)`` without waiting: a CUDA tensor lands in
    pinned memory behind an event recorded after the copy; a CPU tensor is
    its own host copy (event None). :func:`finish_readback` waits."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def finish_readback(handle) -> torch.Tensor:
    """Wait for :func:`start_readback`'s copy (on its event: work queued
    later, on any stream, does not delay it) and return the host tensor."""
    host, event = handle
    if event is not None:
        event.synchronize()
    return host


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
