"""See :func:`perfbench.metrics._shared.idle_pct`."""

from perfbench.metrics._shared import idle_pct as read  # noqa: F401
