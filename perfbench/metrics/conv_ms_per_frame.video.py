"""See :func:`perfbench.metrics._shared.conv_ms_per_frame`."""

from perfbench.metrics._shared import conv_ms_per_frame as read  # noqa: F401
