"""The port's input pipeline (``waternet_tpu_torch.data.pipeline``) and its
host-to-device feeder, on the CPU: order, errors, shutdown and the
instrumentation, each case also run through the JAX package's pipeline,
which must deliver the same. The conftest leak guard checks after every
test that no ``waternet-pipeline`` thread is left."""

import threading
import time

import numpy as np
import pytest
import torch

from waternet_tpu.data import pipeline as jax_pipeline
from waternet_tpu_torch.data import pipeline
from waternet_tpu_torch.utils.tensor import DeviceFeeder

PACKAGES = {"port": pipeline, "jax": jax_pipeline}


def _work(i):
    # Earlier items sleep longer: workers finish out of submission order.
    time.sleep(0.02 if i % 3 == 0 else 0.0)
    return i * i


@pytest.mark.parametrize("pkg", ["port", "jax"])
@pytest.mark.parametrize("workers", [0, 1, 4])
def test_ordered_pipeline_delivers_in_order(pkg, workers):
    pipe = PACKAGES[pkg].OrderedPipeline(_work, range(24), workers=workers)
    assert list(pipe) == [i * i for i in range(24)]
    assert pipe.stats.pops == 24 and pipe.stats.workers == workers
    pipe.close()  # idempotent


def test_ordered_pipeline_inline_mode_is_all_stalls_and_starts_no_thread():
    before = {t.name for t in threading.enumerate()}
    pipe = pipeline.OrderedPipeline(lambda i: i + 1, range(5), workers=0)
    during = [next(pipe), {t.name for t in threading.enumerate()}]
    assert during[1] == before
    assert [during[0], *pipe] == [1, 2, 3, 4, 5]
    assert pipe.stats.stall_pct() == 100.0 and pipe.stats.workers == 0


@pytest.mark.parametrize("workers", [0, 2])
def test_ordered_pipeline_reraises_a_worker_exception_in_order(workers):
    def work(i):
        if i == 3:
            raise RuntimeError("boom at 3")
        return i

    got = []
    pipe = pipeline.OrderedPipeline(work, range(8), workers=workers)
    with pytest.raises(RuntimeError, match="boom at 3"):
        for r in pipe:
            got.append(r)
    assert got == [0, 1, 2]
    pipe.close()
    with pytest.raises(StopIteration):
        next(pipe)


def test_ordered_pipeline_close_mid_iteration_joins_workers():
    pipe = pipeline.OrderedPipeline(lambda i: i, range(100), workers=3, name="close")
    assert next(pipe) == 0
    pipe.close()
    assert not [t for t in threading.enumerate() if t.name.startswith(f"{pipeline.THREAD_PREFIX}-close")]
    with pytest.raises(StopIteration):
        next(pipe)


def test_ordered_pipeline_bounds_the_work_in_flight():
    started = []
    gate = threading.Event()

    def work(i):
        started.append(i)
        gate.wait(5)
        return i

    with pipeline.OrderedPipeline(work, range(50), workers=2, prefetch=3) as pipe:
        pipe._top_up()
        time.sleep(0.1)
        assert len(pipe._fifo) == 3 and len(started) <= 3
        gate.set()
        assert list(pipe) == list(range(50))


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_prefetch_iterator_order_errors_and_early_close(pkg):
    mod = PACKAGES[pkg]
    it = mod.PrefetchIterator(iter(range(10)), depth=3)
    assert list(it) == list(range(10))
    it.close()

    def gen_with_error():
        yield 1
        raise ValueError("stream died")

    it = mod.PrefetchIterator(gen_with_error(), depth=2)
    assert next(it) == 1
    with pytest.raises(ValueError, match="stream died"):
        next(it)

    it = mod.PrefetchIterator(iter(range(10_000)), depth=2, name="early")
    assert next(it) == 0
    it.close()
    assert not it._thread.is_alive()


def test_pipeline_stats_keys_and_values_match_jax():
    stats = {k: mod.PipelineStats() for k, mod in PACKAGES.items()}
    for s in stats.values():
        s.set_workers(2)
        s.add_stage("load", 0.002)
        s.add_stage("load", 0.004)
        s.add_transfer_bytes(100)
        s.add_transfer_bytes(300)
        s.note_pop(True, 0.01, 0)
        s.note_pop(False, 0.0, 2)
    got, want = stats["port"].metrics(), stats["jax"].metrics()
    assert got == want
    assert got["pipeline_load_ms"] == 3.0 and got["pipeline_transfer_bytes_per_batch"] == 200.0
    assert got["pipeline_stall_pct"] == 50.0 and got["pipeline_queue_depth"] == 1.0
    assert set(pipeline.STAGES) == set(jax_pipeline.STAGES)
    assert pipeline.THREAD_PREFIX == jax_pipeline.THREAD_PREFIX


def test_windowed_counter_forgets_old_shards():
    now = [0.0]
    c = pipeline.WindowedCounter(window_sec=10.0, shards=5, clock=lambda: now[0])
    c.add(3)
    now[0] = 4.0
    c.add(2)
    assert c.total() == 5
    now[0] = 11.0  # the first shard (t in [0, 2)) left the window
    assert c.total() == 2
    now[0] = 30.0
    assert c.total() == 0


def test_device_feeder_on_the_cpu_copies_nothing():
    feeder = DeviceFeeder("cpu")
    arrays = (np.arange(12, dtype=np.uint8).reshape(2, 2, 3), np.ones((2, 3), np.float32))
    sent = feeder.send(arrays)
    assert sent[1] is None
    got = feeder.receive(sent)
    for t, a in zip(got, arrays):
        assert t.device.type == "cpu" and t.data_ptr() == a.__array_interface__["data"][0]
        assert torch.equal(t, torch.from_numpy(a))


def test_feeder_from_pipeline_workers_keeps_every_batch():
    """Worker threads send, the consumer receives, in order and intact."""
    feeder = DeviceFeeder("cpu")

    def produce(i):
        return i, feeder.send((np.full((4, 4), i, np.int64),))

    with pipeline.OrderedPipeline(produce, range(30), workers=4) as pipe:
        for i, sent in pipe:
            (t,) = feeder.receive(sent)
            assert int(t.sum()) == 16 * i
