"""The traced sub-window: ``torch.profiler`` over a fixed, short stretch of
the run, reduced to what the per-layer readers take.

A stretch starts after a synchronise and ends with one, and its bounds are
host timestamps taken right after each synchronise, put on the trace's
clock (the Chrome trace's ``ts`` plus ``baseTimeNanoseconds`` is the wall
clock): so every device operation that ran inside it is in the trace, and
the idle time at both ends counts, whatever the tracer recorded. From the
Chrome trace the profiler writes: the device's busy seconds (the union of
kernel, copy and set intervals), the longest idle gaps between them and
when they fell, and each kernel name's launches and seconds; from the
profiler's averages, the device seconds under each operator
(``aten::convolution``).
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPIN = "spin_kernel"
SPIN_CYCLES = 1000  # under a microsecond


class Profile:
    """One profiled stretch. ``host=False`` records the device's activity
    alone (kernels, copies, sets: little cost to the host, so the busy and
    idle shares are the run's own); ``host=True`` also records the host's
    operators on every thread (the device time under each operator), which
    slows the host."""

    def __init__(self, device: torch.device, host: bool):
        self.device = device
        self.host = host
        self._prof = None
        self._t0_ns = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        cuda = self.device.type == "cuda"
        activities = [ProfilerActivity.CPU] if self.host or not cuda else []
        if cuda:
            activities.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        kwargs = {}
        if self.host:
            try:
                from torch._C._profiler import _ExperimentalConfig

                kwargs["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
            except (ImportError, TypeError):
                pass
        self._prof = profile(activities=activities, **kwargs)
        self._prof.start()
        if cuda:
            # The tracer takes its first activity buffer at the first launch
            # (some milliseconds of host time): a tiny kernel before the
            # stretch opens keeps that out of it.
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize(self.device)
        self._t0_ns = time.time_ns()

    def stop(self, read: bool = True):
        """End the stretch; return its summary (None with ``read=False``)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1_ns = time.time_ns()
        self._prof.stop()
        if not read:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                doc = json.load(f)
        finally:
            os.unlink(path)
        out = summarize(doc["traceEvents"], (self._t0_ns, t1_ns), doc.get("baseTimeNanoseconds"))
        out["op_device_s"] = op_device_seconds(self._prof)
        self._prof = None
        return out


def warm(device: torch.device) -> None:
    """Start and stop each kind of stretch once: the first start in a
    process initialises the profiler's device tracing, which takes seconds,
    and belongs in set-up, not in the profiled sub-window."""
    for host in (False, True):
        p = Profile(device, host)
        p.start()
        p.stop(read=False)


def op_device_seconds(prof) -> dict:
    """{operator name: device seconds under it, children included}."""
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0)
        if us:
            out[e.key] = us / 1e6
    return out


def _merge(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(events, bounds_ns, base_ns=None) -> dict:
    """A Chrome trace's events -> {"window_s", "busy_s", "clock_offset_s",
    "kernels": {name: [launches, seconds]}, "device_ops": [[name, seconds]]
    (top 10), "gaps": [[seconds, middle on the wall clock or None]] (the 10
    longest idle gaps)}. ``bounds_ns``: the stretch's host timestamps on the
    wall clock, in nanoseconds; ``base_ns``: the trace's
    ``baseTimeNanoseconds``, which puts its timestamps on the wall clock.

    The window is the host's: it holds every device event of the stretch, so
    the idle time at its ends counts. Where the two clocks disagree, so that
    a device event would fall outside it, the window keeps its length and is
    moved to hold the events (``clock_offset_s`` says by how much); where no
    base is given, it is placed around the events' middle and the gaps carry
    no wall-clock time."""
    device = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e and SPIN not in e.get("name", "")]
    length = (bounds_ns[1] - bounds_ns[0]) / 1e3  # microseconds, as the trace
    spans, kernels = [], defaultdict(lambda: [0, 0.0])
    for e in device:
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        spans.append((a, b))
        k = kernels[e["name"]]
        k[0] += 1
        k[1] += (b - a) / 1e6
    busy = _merge(spans)
    lo, hi = (busy[0][0], busy[-1][1]) if busy else (0.0, 0.0)
    if base_ns is not None:
        w0 = (bounds_ns[0] - base_ns) / 1e3
    else:
        w0 = (lo + hi - length) / 2
    offset = 0.0
    if busy and lo < w0:
        offset = lo - w0
    elif busy and hi > w0 + length:
        offset = hi - (w0 + length)
    w0 += offset
    w1 = max(w0 + length, hi)
    busy_s = sum(b - a for a, b in busy) / 1e6
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:10]
    walls = [[dur / 1e6, None if base_ns is None else ((a + b) / 2 + base_ns / 1e3) / 1e6]
             for dur, a, b in gaps]
    top = sorted(kernels.items(), key=lambda kv: kv[1][1], reverse=True)[:10]
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_s,
        "clock_offset_s": offset / 1e6,
        "kernels": {name: list(v) for name, v in kernels.items()},
        "device_ops": [[name[:120], v[1]] for name, v in top],
        "gaps": walls,
    }


def kernel_seconds(profile: dict, fragment: str):
    """(launches, seconds) of the kernels whose name holds ``fragment``."""
    n, s = 0, 0.0
    for name, (count, sec) in profile["kernels"].items():
        if fragment in name:
            n, s = n + count, s + sec
    return n, s
