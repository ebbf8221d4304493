"""The inference path's stage spans (``obs/stages.py``, ``InferenceEngine``
and ``StudentEngine.enhance_async``, ``utils/tensor.py::ten2arr``) and the
recorder's deferred device time (``TraceRecorder.record_span_timed``), on
the CPU.

Disarmed, the hooks record nothing, read no clock and make no timing
event; armed, one call records its stages inside the caller's span with
their frames and bytes, and leaves the output byte for byte as it was. The
CUDA events are stood in for by fakes, whose ``elapsed_time`` is the host
time between their records: on the CPU the stages carry no device time.
"""

import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from waternet_tpu_torch.inference_engine import InferenceEngine, StudentEngine
from waternet_tpu_torch.obs import stages, trace
from waternet_tpu_torch.obs.trace import TraceRecorder
from waternet_tpu_torch.stage_profile import engine_stages
from waternet_tpu_torch.utils import tensor
from waternet_tpu_torch.utils.tensor import ten2arr

REPO = Path(__file__).resolve().parent.parent
TEACHER = str(REPO / "tests" / "fixtures" / "distill" / "teacher.npz")
STUDENT = str(REPO / "tests" / "fixtures" / "distill" / "student.npz")
ENGINE_SPANS = ("engine.upload", "engine.preprocess", "engine.forward")
READBACK_SPANS = ("readback.wait", "readback.copy")


def frames(n, h=24, w=32, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def engines():
    return {
        "device": InferenceEngine(weights=TEACHER, device_preprocess=True, device="cpu"),
        "host": InferenceEngine(weights=TEACHER, device_preprocess=False, device="cpu"),
        "student": StudentEngine(weights=STUDENT, device="cpu"),
    }


@pytest.fixture
def recorder():
    """The process's recorder, armed and empty; disarmed and emptied after."""
    rec = trace.recorder()
    rec.reset()
    rec.enable()
    try:
        yield rec
    finally:
        rec.disable()
        rec.reset()


class FakeEvent:
    """A timing event on the host's clock; ``done`` says whether the device
    has passed it."""

    def __init__(self, done=True):
        self.t = time.perf_counter()
        self.done = done
        self.synchronized = 0

    def query(self):
        return self.done

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3

    def synchronize(self):
        self.synchronized += 1


def _spans(rec, cat="engine"):
    return [e for e in rec.snapshot()[0] if e[1] == cat and e[2] == "X"]


@pytest.mark.parametrize("kind", ["device", "host", "student"])
def test_disarmed_records_nothing_reads_no_clock_and_makes_no_event(engines, kind, monkeypatch):
    made = {"cuda_event": 0, "device_event": 0, "clock": 0, "sync": 0}

    def count(key, result=None):
        def f(*a, **k):
            made[key] += 1
            return result
        return f

    monkeypatch.setattr(torch.cuda, "Event", count("cuda_event"))
    monkeypatch.setattr(torch.cuda, "synchronize", count("sync"))
    monkeypatch.setattr(stages, "device_event", count("device_event", FakeEvent()))
    clock = types.SimpleNamespace(perf_counter=count("clock", 0.0))
    monkeypatch.setattr(stages, "time", clock)
    monkeypatch.setattr(tensor, "time", clock)
    rec = trace.recorder()
    rec.disable()
    rec.reset()
    ten2arr(engines[kind].enhance_async(frames(2)))
    assert made == {"cuda_event": 0, "device_event": 0, "clock": 0, "sync": 0}
    assert rec.snapshot()[0] == [] and rec.counters()["pending"] == 0


@pytest.mark.parametrize("kind", ["device", "host", "student"])
def test_armed_call_records_its_stages_inside_the_callers_span(engines, kind, recorder):
    batch = frames(2)
    with trace.span("call", "test"):
        ten2arr(engines[kind].enhance_async(batch))
    (call,) = [e for e in recorder.snapshot()[0] if e[0] == "call"]
    spans = _spans(recorder)
    names = [e[0] for e in sorted(spans, key=lambda e: e[3])]
    want = {"device": ["engine.upload", "engine.preprocess", "engine.forward"],
            "host": ["engine.preprocess", "engine.upload", "engine.forward"],
            "student": ["engine.upload", "engine.forward"]}[kind]
    assert names == want + list(READBACK_SPANS)
    planes = 4 if kind == "host" else 1
    for name, cat, ph, t0, dur, tid, args in spans:
        assert call[3] <= t0 and t0 + dur <= call[3] + call[4], name
        assert args["frames"] == 2 and "device_ms" not in args
        if name == "engine.upload":
            assert args["bytes"] == planes * batch.nbytes
        if name == "readback.copy":
            assert args["bytes"] == batch.nbytes
    assert recorder.counters()["pending"] == 0


@pytest.mark.parametrize("kind", ["device", "host", "student"])
def test_armed_and_disarmed_outputs_are_byte_identical(engines, kind):
    rec = trace.recorder()
    batch = frames(3, seed=5)
    rec.disable()
    off = ten2arr(engines[kind].enhance_async(batch))
    rec.reset()
    rec.enable()
    try:
        on = ten2arr(engines[kind].enhance_async(batch))
    finally:
        rec.disable()
        rec.reset()
    assert on.dtype == off.dtype == np.uint8 and on.tobytes() == off.tobytes()


@pytest.mark.parametrize("kind", ["device", "host"])
def test_fake_events_give_each_device_stage_its_device_time(engines, kind, recorder, monkeypatch):
    """With timing events (faked on the CPU), every stage that enqueues
    device work carries ``device_ms``: the readback's wait carries the
    cast's, which it waits on; the host preprocessing and the readback's
    copy carry none."""
    made = []

    def fake(device):
        made.append(FakeEvent())
        return made[-1]

    monkeypatch.setattr(stages, "device_event", fake)
    ten2arr(engines[kind].enhance_async(frames(2)))
    timed = {e[0]: e[6] for e in _spans(recorder)}
    device_stages = {"engine.upload", "engine.forward", "readback.wait"}
    if kind == "device":
        device_stages.add("engine.preprocess")
    assert {k for k, a in timed.items() if "device_ms" in a} == device_stages
    assert all(timed[k]["device_ms"] >= 0 for k in device_stages)
    # Two events a device stage; the cast's end is the one waited for.
    assert len(made) == 2 * len(device_stages)
    assert sum(e.synchronized for e in made) == 1 and made[-1].synchronized == 1


def test_data_sharded_parts_record_their_real_frames(recorder):
    """Three frames over two data shards: the batch is padded to four, and
    each part's spans count its real frames, 2 and 1."""
    engine = InferenceEngine(weights=TEACHER, device_preprocess=True, device="cpu", data_shards=2)
    out = ten2arr(engine.enhance_async(frames(3)))
    assert out.shape[0] == 3
    spans = sorted(_spans(recorder), key=lambda e: e[3])
    for name in ENGINE_SPANS:
        assert [e[6]["frames"] for e in spans if e[0] == name] == [2, 1]
    assert [e[6]["bytes"] for e in spans if e[0] == "engine.upload"] == [frames(2).nbytes] * 2


class _Stream:
    def __init__(self, device):
        self.device = device


@pytest.mark.parametrize("profiling", [False, True])
def test_device_event_is_recorded_on_the_stream_unless_the_profiler_runs(profiling, monkeypatch):
    """A CUDA device gets a timing event recorded on its current stream;
    while ``torch.profiler`` runs (its trace has the device's times) and
    off CUDA, no event is made."""
    made = []

    class Event:
        def __init__(self, enable_timing=False):
            self.enable_timing, self.streams = enable_timing, []
            made.append(self)

        def record(self, stream):
            self.streams.append(stream)

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", _Stream)
    assert stages.device_event("cpu") is None
    if profiling:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            assert stages.device_event("cuda:1") is None
        assert made == []
    else:
        ev = stages.device_event("cuda:1")
        assert made == [ev] and ev.enable_timing
        assert [s.device for s in ev.streams] == [torch.device("cuda", 1)]


def test_armed_readback_under_the_profiler_waits_once(engines, recorder, monkeypatch):
    """While ``torch.profiler`` runs, the armed readback makes no event and
    adds no synchronise: its spans land without device time."""
    waits = []
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: pytest.fail("an event was made"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: waits.append(1))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        ten2arr(engines["device"].enhance_async(frames(2)))
    spans = _spans(recorder)
    assert sorted(e[0] for e in spans) == sorted(ENGINE_SPANS + READBACK_SPANS)
    assert not any("device_ms" in e[6] for e in spans) and waits == []


# -- the recorder's deferred device time -------------------------------------


def test_timed_span_waits_for_its_end_event():
    rec = TraceRecorder(capacity=16)
    rec.enable()
    start, end = FakeEvent(), FakeEvent(done=False)
    end.t = start.t + 0.0025
    rec.record_span_timed("stage", "engine", 1.0, 2.0, start, end, {"frames": 4})
    assert rec.snapshot()[0] == [] and rec.counters()["pending"] == 1
    assert rec.resolve_pending() == 1
    end.done = True
    (ev,) = rec.snapshot()[0]
    assert ev[:5] == ("stage", "engine", "X", 1.0, 1.0)
    assert ev[6] == {"frames": 4, "device_ms": pytest.approx(2.5)}
    assert rec.counters()["pending"] == 0


def test_timed_span_without_events_lands_at_once():
    rec = TraceRecorder(capacity=16)
    rec.enable()
    rec.record_span_timed("stage", "engine", 1.0, 2.0, None, None, {"frames": 1})
    (ev,) = rec.snapshot()[0]
    assert ev[6] == {"frames": 1}


def test_pending_list_is_bounded_and_overflow_is_counted(monkeypatch):
    monkeypatch.setattr(trace, "PENDING_CAPACITY", 2)
    rec = TraceRecorder(capacity=16)
    rec.enable()
    for i in range(3):
        rec.record_span_timed(f"s{i}", "engine", 0.0, 1.0, FakeEvent(), FakeEvent(done=False))
    c = rec.counters()
    assert (c["pending"], c["pending_overflow"], c["spans"]) == (2, 1, 1)
    (ev,) = rec.snapshot()[0]
    assert ev[0] == "s2" and "device_ms" not in ev[6]
    assert rec.to_chrome()["otherData"]["pending_overflow"] == 1


def test_disarmed_and_reset_recorders_keep_nothing_pending():
    rec = TraceRecorder(capacity=16)
    rec.record_span_timed("off", "engine", 0.0, 1.0, FakeEvent(), FakeEvent())
    assert rec.counters()["pending"] == 0
    rec.enable()
    end = FakeEvent(done=False)
    rec.record_span_timed("on", "engine", 0.0, 1.0, FakeEvent(), end)
    rec.disable()  # taken in while armed: lands once the device passes it
    end.done = True
    assert [e[0] for e in rec.snapshot()[0]] == ["on"]
    rec.enable()
    rec.record_span_timed("gone", "engine", 0.0, 1.0, FakeEvent(), FakeEvent())
    rec.reset()
    assert rec.snapshot()[0] == [] and rec.counters() == {
        "spans": 0, "evicted": 0, "capacity": 16, "pending": 0, "pending_overflow": 0}


def test_wall_epoch_puts_spans_on_the_wall_clock():
    """``otherData["wall_epoch_ns"]`` plus a span's ``ts`` is the wall clock
    at the span's start, in microseconds, after a reset too."""
    rec = TraceRecorder(capacity=16)
    rec.enable()
    for _ in range(2):
        time.sleep(0.01)
        t = time.perf_counter()
        wall_ns = time.time_ns()
        rec.record_span("s", "engine", t, t + 0.001)
        doc = rec.to_chrome()
        (ev,) = [e for e in doc["traceEvents"] if e["ph"] == "X"]
        at_us = doc["otherData"]["wall_epoch_ns"] / 1e3 + ev["ts"]
        assert abs(at_us - wall_ns / 1e3) < 5e3
        rec.reset()


def test_concurrent_timed_spans_land_once_each(monkeypatch):
    """Threads recording timed spans while others resolve: every span lands
    once, with its device time, and nothing stays pending."""
    monkeypatch.setattr(trace, "PENDING_CAPACITY", 4096)
    rec = TraceRecorder(capacity=4096)
    rec.enable()
    n_threads, per_thread = 6, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def work(k):
            for i in range(per_thread):
                rec.record_span_timed(f"t{k}", "engine", 0.0, 1.0, FakeEvent(), FakeEvent(), {"i": i})
                if i % 7 == 0:
                    rec.resolve_pending()

        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    evs = rec.snapshot()[0]
    assert rec.counters()["pending"] == 0 and len(evs) == n_threads * per_thread
    assert len({(e[0], e[6]["i"]) for e in evs}) == len(evs)
    assert all("device_ms" in e[6] for e in evs)


def test_stage_profile_reads_the_engines_spans(engines):
    """``stage_profile``'s inference mode times the engine's own spans; on
    the CPU they carry host time alone, and the recorder is left disarmed
    and empty."""
    device_ms, host_ms, calls = engine_stages(engines["device"], frames(2), reps=2)
    assert device_ms == {}
    assert set(host_ms) == set(ENGINE_SPANS + READBACK_SPANS)
    assert all(len(v) == 2 for v in host_ms.values()) and len(calls) == 2
    assert not trace.enabled() and trace.recorder().snapshot()[0] == []
