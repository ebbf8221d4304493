"""The traffic generators: the open loop's schedule and its timing from
due times, and the seeded sample."""

import random
import threading
import time
from concurrent.futures import Future

import numpy as np

from perfbench import harness
from perfbench.traffic import serve
from perfbench.traffic.reservoir import Reservoir
from perfbench.tests.helpers import SEED, TINY


def test_every_seed_sends_the_same_sizes_and_gaps():
    mix = harness.Cell("waternet.serve_mixed_inproc").mix
    a_due, a_which = serve.schedule(mix, 20.0, np.random.default_rng(1))
    b_due, b_which = serve.schedule(mix, 20.0, np.random.default_rng(2))
    gaps_a, gaps_b = np.diff(a_due, prepend=0.0), np.diff(b_due, prepend=0.0)
    assert np.all(gaps_a > 0) and not np.array_equal(a_due, b_due)
    full = np.random.default_rng(mix["gap_seed"]).exponential(1.0 / mix["rate_per_s"], 10_000)
    assert all(np.abs(full - g).min() < 1e-9 for g in gaps_a)
    assert abs(len(a_due) - mix["rate_per_s"] * 20.0) < 4 * np.sqrt(mix["rate_per_s"] * 20.0)
    pop = len(mix["shapes"])
    for which in (a_which, b_which):  # each image once per pass over the population
        for k in range(len(which) // pop):
            assert sorted(which[k * pop:(k + 1) * pop]) == list(range(pop))


class _StallingBatcher:
    """Answers at once, but its first submit blocks the caller."""

    def __init__(self, stall_s):
        self.stall_s, self.calls = stall_s, 0
        self.stats = type("S", (), {"summary": staticmethod(lambda: {"batch_occupancy": 1.0})})()
        self.lock = threading.Lock()

    def submit(self, img):
        with self.lock:
            self.calls += 1
            first = self.calls == 1
        if first:
            time.sleep(self.stall_s)
        fut = Future()
        fut.set_result(img)
        return fut


def test_open_loop_times_requests_from_when_they_were_due():
    overrides = dict(TINY["waternet.serve_mixed_inproc"], **{"mix.rate_per_s": 60.0, "settings.check_requests": 1})
    cell = harness.Cell("waternet.serve_mixed_inproc", overrides=overrides)
    run = harness.Run(cell, SEED, 1.0, False, "cpu")
    pop = [np.zeros((h, w, 3), np.uint8) for h, w in cell.mix["shapes"]]
    out = serve.window(run, {"batcher": _StallingBatcher(0.4), "population": pop})
    # Every request due during the stall waits for it: about 24 of ~60,
    # so the 95th percentile is most of the stall, though each submit after
    # it returns at once.
    assert out["failed"] == 0 and out["attempted"] > 30
    assert out["metrics"]["request_p95_ms"] > 250.0
    assert out["notes"]["p50_ms"] < 50.0 and out["notes"]["late_ms_max"] > 250.0


def test_reservoir_is_seeded_and_uniform():
    picks = [Reservoir(3, random.Random(s)) for s in range(400)]
    for r in picks:
        for i in range(10):
            r.offer(i)
    counts = np.bincount([i for r in picks for i in r.items], minlength=10)
    assert counts.sum() == 1200 and counts.min() > 60
    again = Reservoir(3, random.Random(7))
    for i in range(10):
        again.offer(i)
    assert again.items == picks[7].items
