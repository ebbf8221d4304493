"""The readers of the program's stage spans (``perfbench/metrics/_stages.py``
and its five metric files), on synthetic window spans and on a tiny traced
run on the CPU."""

import pytest

from perfbench import harness
from perfbench.tests.helpers import SEED, TINY

CELL = "waternet.video_1080p"
HOST = ("upload_ms.video", "readback_copy_ms.video")
DEVICE = {"preprocess_device_ms_per_frame.video": "engine.preprocess",
          "forward_device_ms_per_frame.video": "engine.forward"}
READBACK = "readback_device_ms_per_frame.video"
DTOH = "Memcpy DtoH (Device -> Pageable)"


def _run(spans, profile=None, device_frames=None):
    run = harness.Run(harness.Cell(CELL, overrides=TINY[CELL]), SEED, 1.0, True, "cpu")
    run.spans = spans
    run.profile = profile
    if device_frames is not None:
        run.profile_units = {"device": device_frames, "host": device_frames}
    return run


def _span(name, dur_s, args=None, ph="X"):
    return (name, "engine", ph, 0.0, dur_s, 1, args)


def test_host_readers_take_the_median_duration():
    spans = [_span("engine.upload", d) for d in (0.002, 0.004, 0.003)]
    spans += [_span("readback.copy", 0.010), _span("readback.copy", 0.006), _span("enhance_async", 1.0)]
    run = _run(spans)
    assert harness.read_metric(run, "upload_ms.video") == pytest.approx(3.0)
    assert harness.read_metric(run, "readback_copy_ms.video") == pytest.approx(8.0)


@pytest.mark.parametrize("metric,span", sorted(DEVICE.items()))
def test_device_readers_divide_device_time_by_frames(metric, span):
    """Σ device_ms / Σ frames over the spans that carry device time; spans
    without it, instants and other names are left out."""
    spans = [_span(span, 0.5, {"frames": 4, "device_ms": 100.0}),
             _span(span, 0.5, {"frames": 2, "device_ms": 20.0}),
             _span(span, 0.5, {"frames": 4}),
             _span(span, 0.0, {"frames": 4, "device_ms": 999.0}, ph="i"),
             _span("other", 0.5, {"frames": 4, "device_ms": 999.0})]
    assert harness.read_metric(_run(spans), metric) == pytest.approx(20.0)


def test_readback_reader_adds_the_profilers_copies_to_the_cast():
    """The cast's device time a frame from the window's ``readback.wait``
    spans, plus the profiled half's device-to-host copies over its frames;
    host-to-device copies and kernels are left out."""
    spans = [_span("readback.wait", 0.1, {"frames": 4, "device_ms": 2.0}),
             _span("readback.wait", 0.1, {"frames": 4, "device_ms": 2.0}),
             _span("readback.copy", 0.005, {"frames": 4, "bytes": 100})]
    profile = {"kernels": {DTOH: [10, 0.040], "Memcpy HtoD (Pinned -> Device)": [10, 0.5], "k": [3, 1.0]}}
    assert harness.read_metric(_run(spans, profile, 40), READBACK) == pytest.approx(0.5 + 1.0)
    assert harness.read_metric(_run(spans, {"kernels": {"k": [3, 1.0]}}, 40), READBACK) is None
    assert harness.read_metric(_run(spans, None, 40), READBACK) is None
    no_cast = [_span("readback.wait", 0.1, {"frames": 4}), spans[2]]
    assert harness.read_metric(_run(no_cast, profile, 40), READBACK) is None


@pytest.mark.parametrize("metric", sorted(HOST + tuple(DEVICE) + (READBACK,)))
def test_readers_give_none_without_the_programs_spans(metric):
    """A program that records no stage spans (or none with device time)
    leaves each metric out of the line."""
    profile = {"kernels": {DTOH: [10, 0.040]}}
    harness_only = [_span("enhance_async", 0.01), _span("ten2arr", 0.1)]
    assert harness.read_metric(_run(harness_only, profile, 40), metric) is None
    no_device = [_span(name, 0.01, {"frames": 4}) for name in
                 ("engine.upload", "engine.preprocess", "engine.forward", "readback.wait", "readback.copy")]
    assert (harness.read_metric(_run(no_device, profile, 40), metric) is None) == (metric not in HOST)


def test_traced_cpu_run_reads_the_host_stages_alone():
    """On the CPU the engine's spans carry no device time: the traced line
    has the two host-clock stage metrics and none of the three device ones."""
    cell = harness.Cell(CELL, overrides=TINY[CELL])
    line = harness.run_cell(cell, SEED, 0.5, True, "cpu")
    for m in HOST:
        assert line["metrics"][m]["value"] > 0 and line["metrics"][m]["unit"] == "ms"
    assert not (set(DEVICE) | {READBACK}) & set(line["metrics"])
