"""See :func:`perfbench.metrics._stages.median_ms`, over ``readback.copy``."""

from perfbench.metrics._stages import median_ms


def read(run):
    return median_ms(run, "readback.copy")
