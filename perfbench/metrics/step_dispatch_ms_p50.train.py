"""Median of the trainer's ``step_dispatch`` spans in the window: the host
time to enqueue one step (``training/trainer.py``)."""

from perfbench.harness import median


def read(run):
    spans = run.span_ms("step_dispatch")
    return median(spans) if spans else None
