"""Overlapped, deterministic input pipeline for the host-fed paths.

The port of the JAX package's ``data/pipeline.py`` (threads only; its
stall window is :class:`~waternet_tpu_torch.obs.window.WindowedCounter`).

* :class:`OrderedPipeline` — a bounded worker pool (threads; cv2, numpy
  and CUDA copies release the GIL) runs a produce function over a work
  list ahead of the consumer and delivers results **in submission
  order** through a bounded prefetch window. Batch composition is a pure
  function of ``(seed, epoch)`` and each work item carries what its batch
  needs (indices and, for host preprocessing, an RNG state), so workers
  may finish out of order without changing what the consumer sees: the
  pipelined epoch equals the synchronous one bit for bit.
* :class:`PrefetchIterator` — one background thread draining a strictly
  sequential source into a bounded queue, with the same ordering,
  shutdown and error contract.
* :class:`PipelineStats` — per-stage timings (load / preprocess /
  transfer / step), a queue-depth gauge, the host-to-device bytes per
  batch, and the consumer's **stall counter** (pops that had to wait for
  their batch). They surface in the epoch metrics as ``pipeline_*``.

Threads run under :data:`THREAD_PREFIX`, so tests can assert a clean
shutdown; ``close()`` is idempotent, joins every worker and is safe in a
``finally`` mid-iteration. An exception raised in a worker re-raises at
the consumer's pop for that item, in order. ``workers=0`` runs the same
code inline on the consumer thread: the synchronous reference.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from typing import Callable, Iterable, Iterator, Optional

from waternet_tpu_torch.obs.window import WindowedCounter

THREAD_PREFIX = "waternet-pipeline"

STAGES = ("load", "preprocess", "transfer", "step")


class PipelineStats:
    """Thread-safe accumulators for pipeline instrumentation.

    Workers call :meth:`add_stage`/:meth:`stage` for host-stage timings
    and :meth:`add_transfer_bytes` per batch; the consumer's pop loop
    calls :meth:`note_pop` with whether it stalled and the ready-queue
    depth it saw.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._stage_s: dict = {}  # guarded-by: self._lock
        self._stage_n: dict = {}  # guarded-by: self._lock
        self.pops = 0  # guarded-by: self._lock
        self.stalls = 0  # guarded-by: self._lock
        self.stall_s = 0.0  # guarded-by: self._lock
        self._depth_sum = 0  # guarded-by: self._lock
        self.depth_max = 0  # guarded-by: self._lock
        self.workers = 0  # guarded-by: self._lock
        self._transfer_bytes = 0  # guarded-by: self._lock
        self._transfer_batches = 0  # guarded-by: self._lock
        # The trailing-window twin of pops/stalls: is the pipeline keeping
        # up now, not averaged over the whole run.
        self._win_pops = WindowedCounter()
        self._win_stalls = WindowedCounter()

    def set_workers(self, n: int) -> None:
        with self._lock:
            self.workers = int(n)

    def add_stage(self, name: str, seconds: float) -> None:
        with self._lock:
            self._stage_s[name] = self._stage_s.get(name, 0.0) + seconds
            self._stage_n[name] = self._stage_n.get(name, 0) + 1

    def add_transfer_bytes(self, nbytes: int) -> None:
        """Count one batch's host-to-device payload: two uint8 tensors on
        the device-preprocess path, five float32 views on the
        host-preprocess path."""
        with self._lock:
            self._transfer_bytes += int(nbytes)
            self._transfer_batches += 1

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add_stage(name, time.perf_counter() - t0)

    def note_pop(self, stalled: bool, waited_s: float, depth: int) -> None:
        with self._lock:
            self.pops += 1
            if stalled:
                self.stalls += 1
                self.stall_s += waited_s
            self._depth_sum += depth
            self.depth_max = max(self.depth_max, depth)
        self._win_pops.add(1)
        if stalled:
            self._win_stalls.add(1)

    def stage_ms(self, name: str) -> float:
        """Mean per-call milliseconds for ``name`` (0.0 when never timed)."""
        with self._lock:
            n = self._stage_n.get(name, 0)
            return (self._stage_s.get(name, 0.0) / n * 1e3) if n else 0.0

    def stall_pct(self) -> float:
        with self._lock:
            return 100.0 * self.stalls / max(self.pops, 1)

    def stall_pct_window(self) -> float:
        """Stall percentage over the trailing window only."""
        pops = self._win_pops.total()
        if pops <= 0:
            return 0.0
        return 100.0 * self._win_stalls.total() / pops

    def queue_depth_mean(self) -> float:
        with self._lock:
            return self._depth_sum / max(self.pops, 1)

    def transfer_bytes_per_batch(self) -> float:
        """Mean host-to-device payload bytes per batch (0.0 if untracked)."""
        with self._lock:
            return self._transfer_bytes / max(self._transfer_batches, 1)

    def metrics(self, prefix: str = "pipeline_") -> dict:
        """Flat float dict for the epoch metrics: the JAX package's keys."""
        with self._lock:
            workers = float(self.workers)
        out = {
            f"{prefix}stall_pct": round(self.stall_pct(), 2),
            f"{prefix}stall_pct_window": round(self.stall_pct_window(), 2),
            f"{prefix}queue_depth": round(self.queue_depth_mean(), 2),
            f"{prefix}workers": workers,
            f"{prefix}transfer_bytes_per_batch": round(self.transfer_bytes_per_batch(), 1),
        }
        for name in STAGES:
            out[f"{prefix}{name}_ms"] = round(self.stage_ms(name), 3)
        return out


class OrderedPipeline:
    """Bounded worker pool delivering ``fn(item)`` results in submission order.

    Up to ``prefetch`` items are in flight at once (default
    ``max(2 * workers, workers + 1)``); workers complete in any order but
    the consumer always receives the head of the submission FIFO. A stall
    is a pop whose head future was not yet done.

    ``workers=0`` executes ``fn`` inline at pop time (every pop is a stall
    by definition): the instrumented synchronous reference.
    """

    def __init__(
        self,
        fn: Callable,
        items: Iterable,
        workers: int = 2,
        prefetch: int = 0,
        stats: Optional[PipelineStats] = None,
        name: str = "batches",
    ):
        self.fn = fn
        self._items = iter(items)
        self.workers = max(0, int(workers))
        self.prefetch = (
            int(prefetch) if prefetch and prefetch > 0 else max(2 * self.workers, self.workers + 1)
        )
        self.stats = stats if stats is not None else PipelineStats()
        self.stats.set_workers(self.workers)
        # Touched by the consumer thread only: workers run fn(), never the FIFO.
        self._fifo: deque = deque()
        self._closed = False
        self._pool = (
            ThreadPoolExecutor(max_workers=self.workers, thread_name_prefix=f"{THREAD_PREFIX}-{name}")
            if self.workers
            else None
        )

    def _top_up(self) -> None:
        while self._pool is not None and len(self._fifo) < self.prefetch:
            try:
                item = next(self._items)
            except StopIteration:
                break
            # jaxlint: disable-next=R101 _fifo is consumer-thread-only: workers run fn(), never touch the FIFO
            self._fifo.append(self._pool.submit(self.fn, item))

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        if self._pool is None:  # inline (synchronous reference) mode
            try:
                item = next(self._items)
            except StopIteration:
                self.close()
                raise
            t0 = time.perf_counter()
            result = self.fn(item)
            self.stats.note_pop(True, time.perf_counter() - t0, 0)
            return result
        self._top_up()
        if not self._fifo:
            self.close()
            raise StopIteration
        # jaxlint: disable-next=R101 _fifo is consumer-thread-only: workers run fn(), never touch the FIFO
        fut = self._fifo.popleft()
        stalled = not fut.done()
        t0 = time.perf_counter()
        try:
            result = fut.result()
        except BaseException:
            self.close()
            raise
        waited = time.perf_counter() - t0
        depth = sum(1 for f in self._fifo if f.done())
        self.stats.note_pop(stalled, waited, depth)
        self._top_up()
        return result

    def close(self) -> None:
        """Cancel queued work, wait for in-flight items, join every worker.
        Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._items = iter(())
        for fut in self._fifo:
            fut.cancel()
        # jaxlint: disable-next=R101 _fifo is consumer-thread-only: workers run fn(), never touch the FIFO
        self._fifo.clear()
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def __enter__(self) -> "OrderedPipeline":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class PrefetchIterator:
    """Single background thread draining a sequential ``src`` iterator into
    a bounded queue of depth ``depth``.

    For sources that cannot be fanned out (a video capture decodes frame N
    before N+1). Order is trivially preserved; source exceptions re-raise
    at the consumer's pop; :meth:`close` stops the producer promptly even
    when the consumer abandons the stream mid-iteration.
    """

    _ITEM, _DONE, _ERROR = 0, 1, 2

    def __init__(
        self,
        src: Iterable,
        depth: int = 2,
        stats: Optional[PipelineStats] = None,
        name: str = "stream",
    ):
        self._src = iter(src)
        self._q: queue.Queue = queue.Queue(maxsize=max(1, int(depth)))
        self._stop = threading.Event()
        self.stats = stats if stats is not None else PipelineStats()
        self.stats.set_workers(1)
        self._finished = False
        self._thread = threading.Thread(target=self._run, name=f"{THREAD_PREFIX}-{name}", daemon=True)
        self._thread.start()

    def _put(self, kind, value) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put((kind, value), timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _run(self) -> None:
        try:
            for item in self._src:
                if not self._put(self._ITEM, item):
                    return
            self._put(self._DONE, None)
        except BaseException as err:  # re-raised at the consumer's pop
            self._put(self._ERROR, err)

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._finished:
            raise StopIteration
        stalled = self._q.empty()
        t0 = time.perf_counter()
        kind, value = self._q.get()
        self.stats.note_pop(stalled, time.perf_counter() - t0, self._q.qsize())
        if kind == self._DONE:
            self.close()
            raise StopIteration
        if kind == self._ERROR:
            self.close()
            raise value
        return value

    def close(self) -> None:
        """Stop the producer and join it. Idempotent; safe mid-iteration."""
        if self._finished and not self._thread.is_alive():
            return
        self._finished = True
        self._stop.set()
        # Unblock a producer stuck in put() by draining whatever is queued.
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=10.0)

    def __enter__(self) -> "PrefetchIterator":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
