"""The traced sub-window's reduction: bounds from the host's timestamps,
so the idle time at both ends counts whatever the tracer recorded."""

import pytest

from perfbench import profiling

BASE_NS = 1_000_000_000_000


def _kernel(ts, dur, name="conv"):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}


def _bounds(t0_us, t1_us):
    return (BASE_NS + int(t0_us * 1e3), BASE_NS + int(t1_us * 1e3))


def test_idle_at_both_ends_counts():
    """Kernels at 100-200 and 300-400 us of a 0-1000 us stretch: busy 200 us
    of 1000, the 600 us after the last kernel the longest gap."""
    events = [_kernel(100, 100), _kernel(300, 100)]
    out = profiling.summarize(events, _bounds(0, 1000), BASE_NS)
    assert out["window_s"] == pytest.approx(1e-3)
    assert out["busy_s"] == pytest.approx(2e-4)
    assert out["clock_offset_s"] == 0.0
    assert [g[0] for g in out["gaps"]] == pytest.approx([6e-4, 1e-4, 1e-4])
    assert out["gaps"][0][1] == pytest.approx((BASE_NS / 1e3 + 700) / 1e6)


def test_spin_kernels_are_neither_busy_nor_bounds():
    """With or without the spin kernel the tracer may miss, the window and
    the busy time are the same."""
    events = [_kernel(100, 100)]
    spun = events + [_kernel(-50, 1, "at::cuda::(anonymous namespace)::spin_kernel(long)")]
    for evs in (events, spun):
        out = profiling.summarize(evs, _bounds(0, 1000), BASE_NS)
        assert out["window_s"] == pytest.approx(1e-3) and out["busy_s"] == pytest.approx(1e-4)
        assert set(out["kernels"]) == {"conv"}


def test_clock_disagreement_moves_the_window_and_keeps_its_length():
    events = [_kernel(1050, 100)]  # ends 150 us past the host's window
    out = profiling.summarize(events, _bounds(0, 1000), BASE_NS)
    assert out["window_s"] == pytest.approx(1e-3)
    assert out["clock_offset_s"] == pytest.approx(1.5e-4)
    assert out["busy_s"] == pytest.approx(1e-4)


def test_without_a_base_the_window_is_placed_around_the_events():
    out = profiling.summarize([_kernel(5000, 100)], _bounds(0, 1000))
    assert out["window_s"] == pytest.approx(1e-3) and out["busy_s"] == pytest.approx(1e-4)
    assert all(g[1] is None for g in out["gaps"])
    assert sum(g[0] for g in out["gaps"]) == pytest.approx(9e-4)
