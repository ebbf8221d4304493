"""See :func:`perfbench.metrics._stages.readback_ms_per_frame`."""

from perfbench.metrics._stages import readback_ms_per_frame as read  # noqa: F401
