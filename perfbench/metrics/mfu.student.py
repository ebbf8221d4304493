"""See :func:`perfbench.metrics._shared.mfu_video`."""

from perfbench.metrics._shared import mfu_video as read  # noqa: F401
