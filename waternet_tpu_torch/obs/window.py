"""Sliding-window metric primitives.

The JAX package's ``obs/window.py``, lifted (it imports nothing of JAX).
The trainer's :class:`~waternet_tpu_torch.training.trainer.TrainPerf`
and the input pipeline's stall window read it; a quantile over a
since-process-start reservoir would report stale history after warmup or
an incident. These primitives answer "what is the p99 *right now*" with the
same design constraints as :mod:`waternet_tpu_torch.obs.trace`:

* **Disabled means free.** Every ``record``/``add``/``set`` starts with
  one attribute load + bool check on the module switch and returns —
  no lock, no clock read.
* **Bounded memory.** A :class:`LogLinearHistogram` is a sparse dict of
  log-linear buckets (HDR-histogram style: linear sub-buckets inside
  each power-of-two octave, ≤ ~6% relative quantile error), O(1) per
  record. A :class:`WindowedHistogram` keeps a ring of per-shard
  histograms and forgets by overwriting stale shards — memory is
  O(shards × occupied buckets) forever, independent of load duration.
* **No threads of its own.** Shard rotation is lazy: whoever records or
  reads advances the ring against the injected ``clock``. Tests drive a
  fake clock, so window behavior is pinned without a single sleep.
* **Lock-light.** One plain ``threading.Lock`` per primitive; critical
  sections are a few arithmetic ops. Feeding code (the trainer loop)
  calls these OUTSIDE its own lock, so no new lock-order edges appear.

One ring serves every window length: the ring spans the LONG window
(default 300 s in 10 s shards) and a read merges only the trailing
shards it needs, so the short (60 s) and long (300 s) views an SLO
burn-rate evaluation compares come from the same recorded data.
"""

from __future__ import annotations

import threading
import time
from math import frexp, inf
from typing import Dict, List, Optional, Tuple

#: Default short window: "current" latency/throughput, the /stats
#: ``latency_ms_window`` horizon and the fast SLO burn window.
DEFAULT_WINDOW_SEC = 60.0

#: Default long window = ring span: the sustained SLO burn window.
DEFAULT_LONG_WINDOW_SEC = 300.0

#: Default shard granularity: windows forget in steps of this.
DEFAULT_SHARD_SEC = 10.0

#: Linear sub-buckets per power-of-two octave. 16 bounds the quantile
#: upper-bound error at 1/16 of the octave width (~6% relative).
SUBBUCKETS = 16

#: frexp exponent clamp: 2**-21 .. 2**42 covers sub-microsecond
#: latencies in ms through HBM byte counts without index blowup.
_EMIN, _EMAX = -21, 42

#: Canonical Prometheus ``le`` ladder for latency histograms (ms).
DEFAULT_LE_MS = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0,
)


class _Switch:
    """Module-wide arm/disarm for every window primitive.

    Mirrors trace.py's recorder flag: hot paths read ``_enabled``
    without the lock (a stale read merely drops or keeps one sample
    across the toggle edge); writes hold it.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._enabled = True  # guarded-by: self._lock

    def enable(self) -> None:
        with self._lock:
            self._enabled = True

    def disable(self) -> None:
        with self._lock:
            self._enabled = False


#: Process-wide switch — windows are ON by default (unlike tracing, the
#: windowed quantiles are what /metrics reports, so they must be live on
#: an unconfigured server). bench.py's obs A/B disables them for its
#: "off" arm. Never reassigned.
_SWITCH = _Switch()


def enabled() -> bool:
    return _SWITCH._enabled


def enable() -> None:
    _SWITCH.enable()


def disable() -> None:
    _SWITCH.disable()


def bucket_index(value: float) -> int:
    """Log-linear bucket index of ``value`` — O(1), no search.

    ``frexp`` splits v = m * 2**e with m in [0.5, 1); the octave ``e``
    picks a run of :data:`SUBBUCKETS` linear buckets and the mantissa
    picks one. Values <= 0 land in bucket 0.
    """
    if value <= 0.0:
        return 0
    m, e = frexp(value)
    e = min(max(e, _EMIN), _EMAX)
    sub = int((2.0 * m - 1.0) * SUBBUCKETS)
    if sub >= SUBBUCKETS:  # m rounded up to 1.0 at float edge
        sub = SUBBUCKETS - 1
    return (e - _EMIN) * SUBBUCKETS + sub


def bucket_upper(idx: int) -> float:
    """Inclusive upper bound of bucket ``idx`` (its reported quantile)."""
    if idx <= 0:
        # Bucket 0 also absorbs <= 0 records; its honest upper bound is
        # the smallest representable bucket edge.
        idx = 0
    e = idx // SUBBUCKETS + _EMIN
    sub = idx % SUBBUCKETS
    return (0.5 + (sub + 1) / (2.0 * SUBBUCKETS)) * (2.0 ** e)


class LogLinearHistogram:
    """Sparse HDR-style histogram: O(1) record, mergeable, quantiles.

    NOT self-locked: instances live inside a locked owner (a
    :class:`WindowedHistogram` shard ring) or are short-lived merged
    snapshots owned by one reader thread.
    """

    __slots__ = ("counts", "count", "total", "vmin", "vmax")

    def __init__(self):
        self.counts: Dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.vmin = inf
        self.vmax = -inf

    def record(self, value: float) -> None:
        idx = bucket_index(value)
        self.counts[idx] = self.counts.get(idx, 0) + 1
        self.count += 1
        self.total += value
        if value < self.vmin:
            self.vmin = value
        if value > self.vmax:
            self.vmax = value

    def merge(self, other: "LogLinearHistogram") -> None:
        for idx, n in other.counts.items():
            self.counts[idx] = self.counts.get(idx, 0) + n
        self.count += other.count
        self.total += other.total
        if other.vmin < self.vmin:
            self.vmin = other.vmin
        if other.vmax > self.vmax:
            self.vmax = other.vmax

    def clear(self) -> None:
        self.counts.clear()
        self.count = 0
        self.total = 0.0
        self.vmin = inf
        self.vmax = -inf

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile as a bucket upper bound, clamped to the
        observed max (so single-bucket distributions report exactly)."""
        if self.count == 0:
            return 0.0
        rank = min(self.count - 1, max(0, int(round(q * (self.count - 1)))))
        seen = 0
        for idx in sorted(self.counts):
            seen += self.counts[idx]
            if seen > rank:
                return min(bucket_upper(idx), self.vmax)
        return self.vmax  # unreachable with count > 0

    def count_le(self, threshold: float) -> int:
        """Records known to be <= ``threshold``: full buckets whose upper
        bound fits (boundary-quantized, never over-counts a straddling
        bucket — an SLO "over threshold" count errs toward alarm)."""
        return sum(
            n for idx, n in self.counts.items()
            if bucket_upper(idx) <= threshold
        )

    def cumulative(self, bounds=DEFAULT_LE_MS) -> List[int]:
        """Cumulative counts at each of ``bounds`` — the Prometheus
        histogram ``le`` samples (the ``+Inf`` bucket is ``count``)."""
        out = []
        acc = 0
        items = sorted(self.counts.items())
        i = 0
        for le in bounds:
            while i < len(items) and bucket_upper(items[i][0]) <= le:
                acc += items[i][1]
                i += 1
            out.append(acc)
        return out


class WindowedHistogram:
    """A ring of per-shard histograms = a sliding-window histogram.

    The ring spans ``window_sec`` split into ``shards`` sub-windows;
    :meth:`merged` folds the trailing shards covering any window up to
    the ring span, so one instance serves both the short and the long
    SLO burn windows. Rotation is lazy against the injected ``clock`` —
    no threads, deterministic under a fake clock.
    """

    def __init__(
        self,
        window_sec: float = DEFAULT_LONG_WINDOW_SEC,
        shards: Optional[int] = None,
        clock=None,
    ):
        if shards is None:
            shards = max(1, int(round(window_sec / DEFAULT_SHARD_SEC)))
        if window_sec <= 0 or shards <= 0:
            raise ValueError("window_sec and shards must be positive")
        self.window_sec = float(window_sec)
        self.shards = int(shards)
        self.shard_sec = self.window_sec / self.shards
        self._clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        # Ring slot i holds [shard_epoch, histogram]; a slot whose epoch
        # is stale is cleared lazily on the next touch.
        self._ring: List[list] = [  # guarded-by: self._lock
            [-1, LogLinearHistogram()] for _ in range(self.shards)
        ]

    def _epoch(self, now: float) -> int:
        return int(now // self.shard_sec)

    # guarded-by: self._lock (callers hold it)
    def _shard(self, epoch: int) -> LogLinearHistogram:
        slot = self._ring[epoch % self.shards]
        if slot[0] != epoch:
            slot[0] = epoch
            slot[1].clear()
        return slot[1]

    def record(self, value: float) -> None:
        if not _SWITCH._enabled:
            return
        now = self._clock()
        with self._lock:
            self._shard(self._epoch(now)).record(float(value))

    def merged(self, window_sec: Optional[float] = None) -> LogLinearHistogram:
        """A fresh histogram folding the shards of the trailing window
        (default: the full ring span). Safe to read without further
        locking — the merge copies under the lock."""
        span = self.window_sec if window_sec is None else float(window_sec)
        k = max(1, min(self.shards, int(round(span / self.shard_sec))))
        out = LogLinearHistogram()
        now = self._clock()
        cur = self._epoch(now)
        with self._lock:
            for slot_epoch, hist in self._ring:
                if cur - k < slot_epoch <= cur:
                    out.merge(hist)
        return out

    def count(self, window_sec: Optional[float] = None) -> int:
        return self.merged(window_sec).count


class WindowedCounter:
    """Sliding-window event counter / rate (shed rate, error rate...).

    Same lazy shard ring as :class:`WindowedHistogram`, holding one
    float per shard.
    """

    def __init__(
        self,
        window_sec: float = DEFAULT_LONG_WINDOW_SEC,
        shards: Optional[int] = None,
        clock=None,
    ):
        if shards is None:
            shards = max(1, int(round(window_sec / DEFAULT_SHARD_SEC)))
        if window_sec <= 0 or shards <= 0:
            raise ValueError("window_sec and shards must be positive")
        self.window_sec = float(window_sec)
        self.shards = int(shards)
        self.shard_sec = self.window_sec / self.shards
        self._clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        self._ring: List[list] = [  # guarded-by: self._lock
            [-1, 0.0] for _ in range(self.shards)
        ]

    def add(self, n: float = 1.0) -> None:
        if not _SWITCH._enabled:
            return
        now = self._clock()
        epoch = int(now // self.shard_sec)
        with self._lock:
            slot = self._ring[epoch % self.shards]
            if slot[0] != epoch:
                slot[0] = epoch
                slot[1] = 0.0
            slot[1] += n

    def total(self, window_sec: Optional[float] = None) -> float:
        span = self.window_sec if window_sec is None else float(window_sec)
        k = max(1, min(self.shards, int(round(span / self.shard_sec))))
        cur = int(self._clock() // self.shard_sec)
        with self._lock:
            return sum(
                v for epoch, v in self._ring if cur - k < epoch <= cur
            )

    def rate(self, window_sec: Optional[float] = None) -> float:
        """Events per second over the trailing window."""
        span = self.window_sec if window_sec is None else float(window_sec)
        span = min(span, self.window_sec)
        return self.total(span) / span if span > 0 else 0.0


class Gauge:
    """Last-value + peak gauge (HBM bytes, live MFU).

    ``set`` honors the module switch like every recorder; reads return
    ``None`` until the first set, so "never measured" (CPU hosts without
    ``memory_stats()``) stays distinguishable from 0.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._last: Optional[float] = None  # guarded-by: self._lock
        self._peak: Optional[float] = None  # guarded-by: self._lock

    def set(self, value: float) -> None:
        if not _SWITCH._enabled:
            return
        v = float(value)
        with self._lock:
            self._last = v
            if self._peak is None or v > self._peak:
                self._peak = v

    def last(self) -> Optional[float]:
        with self._lock:
            return self._last

    def peak(self) -> Optional[float]:
        with self._lock:
            return self._peak


def quantile_block(
    hist: LogLinearHistogram, quantiles=(0.50, 0.95, 0.99), digits: int = 3
) -> Dict[str, float]:
    """``{"p50": ..., "p95": ..., "p99": ..., "count": n}`` — the /stats
    windowed-quantile schema, shared by serving and the load generator."""
    out: Dict[str, float] = {
        f"p{int(q * 100)}": round(hist.quantile(q), digits)
        for q in quantiles
    }
    out["count"] = hist.count
    return out


def histogram_block(
    hist: LogLinearHistogram, bounds=DEFAULT_LE_MS
) -> Dict[str, object]:
    """The JSON form /metrics renders as a true Prometheus histogram:
    cumulative counts per ``le`` bound plus total count and sum."""
    return {
        "le": [float(b) for b in bounds],
        "cumulative": hist.cumulative(bounds),
        "count": hist.count,
        "sum": round(hist.total, 6),
    }
