"""See :func:`perfbench.metrics._shared.enqueue_ms`."""

from perfbench.metrics._shared import enqueue_ms as read  # noqa: F401
