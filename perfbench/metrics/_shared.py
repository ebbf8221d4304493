"""Readings that several per-layer metrics take, each in the cells of its
own ``moves``."""

from perfbench.counts import flops
from perfbench.harness import median


def idle_pct(run):
    """The share of the profiled sub-window's device-only half in which no
    kernel, copy or set ran on the device, in percent."""
    if not run.profile or not run.profile["window_s"]:
        return None
    return 100.0 * (1.0 - run.profile["busy_s"] / run.profile["window_s"])


def enqueue_ms(run):
    """Median host milliseconds of one ``enhance_async`` call in the window:
    the engine's upload and launches, before the host waits on the device."""
    spans = run.host.get("enqueue_s")
    return median(spans) * 1e3 if spans else None


def conv_ms_per_frame(run):
    """Device milliseconds under ``aten::convolution`` per frame, over the
    host-recorded half of the profiled sub-window."""
    frames = run.profile_units.get("host")
    sec = run.profile["op_device_s"].get("aten::convolution") if run.profile else None
    return sec / frames * 1e3 if frames and sec else None


def mfu_video(run):
    """The window's frames/s times one frame's forward FLOPs
    (``perfbench/counts/flops.py``) over the card's bf16 dense peak, in
    percent."""
    peak = run.peak("bf16_flops_per_s")
    if peak is None or not run.host.get("frames"):
        return None
    h, w = run.host["frame_shape"]
    rate = run.host["frames"] / run.host["window_s"]
    return 100.0 * rate * flops.forward(run.config, h, w) / peak
