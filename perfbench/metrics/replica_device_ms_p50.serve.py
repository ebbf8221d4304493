"""Median of the replicas' ``device`` spans in the window: a batch's
launch to its result on the host, one span per request
(``serving/replicas.py``)."""

from perfbench.harness import median


def read(run):
    spans = run.span_ms("device")
    return median(spans) if spans else None
