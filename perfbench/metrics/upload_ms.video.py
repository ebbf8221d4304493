"""See :func:`perfbench.metrics._stages.median_ms`, over ``engine.upload``."""

from perfbench.metrics._stages import median_ms


def read(run):
    return median_ms(run, "engine.upload")
