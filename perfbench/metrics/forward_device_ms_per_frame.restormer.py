"""See :func:`perfbench.metrics._stages.device_ms_per_frame`, over ``engine.forward``."""

from perfbench.metrics._stages import device_ms_per_frame


def read(run):
    return device_ms_per_frame(run, "engine.forward")
