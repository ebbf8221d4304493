"""Stage spans of the inference path (cat ``engine``), and of a model's
blocks (cat ``model``, ``models/restormer.py``), each with the device's
time between two CUDA timing events.

An engine call opens a :func:`stage_clock` on entry. Each stage ends with
:meth:`StageClock.end`, which records the span from the previous stage's
end (or the call's entry) to now; a stage that enqueues device work calls
:meth:`StageClock.begin` right before its first launch or copy, and its
span then carries ``device_ms``, the time from that event to one recorded
at its end, on the same stream (``TraceRecorder.record_span_timed``). The
host's staging before a stage's first launch (a copy into pinned memory)
stays out of the device bracket, so an idle device waiting on the host
counts in no stage.

While ``torch.profiler`` runs, no timing event is made: the profiler's
trace holds the device's times, and the events (and the readback's
synchronise on one, ``utils/tensor.py::ten2arr``) would only change what
it records. The spans are still recorded, without ``device_ms``.

Disarmed, :func:`stage_clock` returns :data:`DISARMED`, whose methods do
nothing: no clock read, no event, no synchronise.
"""

from __future__ import annotations

import time

import torch
from torch.autograd import profiler as autograd_profiler

from waternet_tpu_torch.obs import trace

CAT = "engine"


def device_event(device):
    """A ``torch.cuda.Event(enable_timing=True)`` recorded now on
    ``device``'s current stream; None for a device that is not CUDA, or
    while ``torch.profiler`` runs."""
    device = torch.device(device)
    if device.type != "cuda" or getattr(autograd_profiler, "_is_profiler_enabled", False):
        return None
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    return event


class StageClock:
    """One call's consecutive stage spans on the host's clock, in span
    category ``cat``."""

    def __init__(self, cat: str = CAT):
        self._cat = cat
        self._t = time.perf_counter()
        self._start = None

    def begin(self, device) -> None:
        """The stage's first device work on ``device`` is enqueued next."""
        self._start = device_event(device)

    def end(self, name: str, device, **args) -> None:
        """Close stage ``name`` (its device work, if :meth:`begin` was
        called, on ``device``) with ``args``; the next stage starts here."""
        end = device_event(device) if self._start is not None else None
        t = time.perf_counter()
        trace.record_span_timed(name, self._cat, self._t, t, self._start, end, args)
        self._t, self._start = t, None


class _Disarmed:
    def begin(self, device) -> None:
        pass

    def end(self, name: str, device, **args) -> None:
        pass


DISARMED = _Disarmed()


def stage_clock(cat: str = CAT):
    """A :class:`StageClock` of ``cat`` started now when the recorder is
    armed, else :data:`DISARMED`."""
    return StageClock(cat) if trace.enabled() else DISARMED
