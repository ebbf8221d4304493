"""Median of the batcher's ``coalesce`` spans in the window: admission to
the flush of the request's batch (``serving/batcher.py``)."""

from perfbench.harness import median


def read(run):
    spans = run.span_ms("coalesce")
    return median(spans) if spans else None
