"""Readings of the program's own stage spans (cat ``engine``: the
inference engine's ``engine.upload``/``engine.preprocess``/
``engine.forward`` and ``ten2arr``'s ``readback.wait``/``readback.copy``)
among the window's spans (``run.spans``). A program without those spans
gives None."""

from perfbench.harness import median
from perfbench.profiling import kernel_seconds


def median_ms(run, name):
    """Median host milliseconds of the window's ``name`` spans."""
    return median(run.span_ms(name))


def device_ms_per_frame(run, name):
    """Σ ``device_ms`` over Σ ``frames`` of the window's ``name`` spans that
    carry device time (CUDA timing events around the stage)."""
    device_ms = frames = 0
    for e in run.spans:
        args = e[6]
        if e[0] == name and e[2] == "X" and args and "device_ms" in args:
            device_ms += args["device_ms"]
            frames += args.get("frames", 0)
    return device_ms / frames if frames else None


def readback_ms_per_frame(run):
    """The readback's device milliseconds a frame: the uint8 cast's, from
    the window's ``readback.wait`` spans, plus the device-to-host copies',
    from the profiler's ``Memcpy DtoH`` over the device-only half's frames
    (the program leaves the copy out of its events: into pageable memory it
    runs at the host's pace)."""
    cast = device_ms_per_frame(run, "readback.wait")
    frames = run.profile_units.get("device")
    if cast is None or not run.profile or not frames:
        return None
    n, sec = kernel_seconds(run.profile, "Memcpy DtoH")
    return cast + sec * 1e3 / frames if n else None
