"""Compute reuse: temporal frame-delta gating for streams and a
content-addressed response cache for ``/enhance`` (docs/SERVING.md
"Temporal reuse & response cache").

The JAX package's ``serving/reuse.py``, lifted (it imports nothing of
JAX). The port's server backs ``--response-cache`` with
:class:`ResponseCache`; :class:`FrameDeltaGate` waits for the stream
sessions (ROADMAP Queue A item 6, streams).

Real underwater feeds — ROV pilots holding station, moorings,
surveillance pans — are dominated by static or slow-panning scenes, yet
the serving stack recomputes the full network for every frame. Two
independent reuse layers turn that redundancy into throughput:

* :class:`FrameDeltaGate` — per-stream temporal gating, split into a
  read-time *decision* and a delivery-time *materialization*. The
  session keeps a decimated grayscale thumbnail of the last frame
  SUBMITTED for compute (the anchor); each incoming frame scores a
  cheap mean-absolute delta against that thumbnail (optionally the
  minimum over a coarse block-flow search, which recognises slow pans)
  and, at or below the threshold, is marked for reuse and never enters
  the batcher. Anchoring on submission rather than on delivery is what
  makes reuse work under backlog: an open-loop camera that outruns the
  server still gates frames 1..N against frame 0 while frame 0 is
  still computing. Because sessions deliver strictly in order, the
  anchor's enhanced output is recorded before any of its reuse
  children are materialized; if the anchor never delivered (dropped or
  errored), the children become honest ``anchor`` drops instead of
  replaying the wrong scene. Scores always compare against the last
  SUBMITTED frame, never the last reused one, so slow drift
  accumulates until it crosses the threshold and forces a recompute —
  reuse cannot creep away from the content. A ``max_reuse_run`` cap
  bounds staleness: after that many consecutive reuses the next frame
  recomputes no matter what the detector says, so a stuck detector can
  never freeze a stream.
* :class:`ResponseCache` — a bounded, thread-safe LRU over fully
  rendered ``/enhance`` answers, keyed on (payload digest, tier, bucket
  ladder identity, params generation). ``invalidate()`` (wired to
  ``POST /admin/reload``) bumps the generation and clears the table, so
  an answer computed under old weights can never serve after a reload.

Exactness: a delta-of-zero frame reuses the *identical* enhanced array,
and the PNG encoder is deterministic, so the reused record is
byte-identical to what a recompute would have produced; likewise a
cache hit replays the exact stored bytes. Both layers are off by
default and tests pin that the disabled paths are byte-identical to the
always-compute behavior (tests/test_reuse.py).

Numpy only — the whole point is that the gate never touches jax, so
reused frames compile nothing and cost no device time.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np

#: Delta scores are computed on an at-most this-many-cells-per-edge
#: grayscale thumbnail (strided sampling — no resize dependency). Small
#: enough to be free next to a decode, large enough that a scene cut is
#: unmistakable.
DECIMATED_EDGE = 64

#: Coarse block-flow search radius, in decimated-grid cells per axis.
#: With warp enabled the gate scores min over (2R+1)^2 integer offsets,
#: so a pan of up to R cells per frame still gates as "same scene".
FLOW_RADIUS = 2

#: Default staleness cap: consecutive reuses before a recompute is
#: forced regardless of the delta score.
DEFAULT_MAX_REUSE_RUN = 30


def decimate(rgb: np.ndarray) -> np.ndarray:
    """Grayscale thumbnail of ``rgb`` by strided sampling, float32 in
    the input's value range. O(cells) work, no interpolation — the gate
    needs a stable cheap signature, not a pretty preview."""
    h, w = rgb.shape[:2]
    sy = max(1, h // DECIMATED_EDGE)
    sx = max(1, w // DECIMATED_EDGE)
    small = np.asarray(rgb[::sy, ::sx], dtype=np.float32)
    if small.ndim == 3:
        small = small.mean(axis=-1)
    return small


def delta_score(a: np.ndarray, b: np.ndarray) -> float:
    """Mean absolute difference between two equal-shape thumbnails
    (uint8 scale for uint8 inputs). 0.0 for identical frames."""
    return float(np.mean(np.abs(a - b)))


def block_flow(
    prev: np.ndarray, cur: np.ndarray, radius: int = FLOW_RADIUS
) -> Tuple[float, Tuple[int, int]]:
    """Coarse translational flow on the decimated grid: the integer
    offset ``(dx, dy)`` within ``radius`` minimizing the overlap MAE,
    with the backward-mapping convention of metrics/flicker.py —
    content at ``(x, y)`` in ``cur`` came from ``(x + dx, y + dy)`` in
    ``prev``. Returns ``(best_score, (dx, dy))``; ``(0, 0)`` wins ties,
    so a truly static frame never reports spurious motion."""
    h, w = cur.shape
    best = (delta_score(prev, cur), (0, 0))
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dx == 0 and dy == 0:
                continue
            cy = slice(max(0, -dy), h - max(0, dy))
            cx = slice(max(0, -dx), w - max(0, dx))
            py = slice(max(0, dy), h - max(0, -dy))
            px = slice(max(0, dx), w - max(0, -dx))
            if cy.start >= cy.stop or cx.start >= cx.stop:
                continue
            score = delta_score(prev[py, px], cur[cy, cx])
            if score < best[0]:
                best = (score, (dx, dy))
    return best


def shift_frame(frame: np.ndarray, dx: float, dy: float) -> np.ndarray:  # loop-blocking: full-resolution numpy warp, milliseconds per frame
    """Motion-compensate ``frame`` by a constant backward flow
    ``(dx, dy)`` pixels (metrics/flicker.py warp semantics). Pixels
    whose source falls outside the frame keep their un-warped value —
    the cached content is a better guess at the newly exposed edge than
    clamped-border smear."""
    from waternet_tpu_torch.metrics.flicker import warp

    h, w = frame.shape[:2]
    flow = np.empty((h, w, 2), dtype=np.float32)
    flow[..., 0] = dx
    flow[..., 1] = dy
    warped, valid = (t.numpy() for t in warp(frame, flow))
    out = frame.astype(np.float32).copy()
    out[valid] = warped[valid]
    if np.issubdtype(frame.dtype, np.integer):
        info = np.iinfo(frame.dtype)
        out = np.clip(np.rint(out), info.min, info.max)
    return out.astype(frame.dtype)


class FrameDeltaGate:
    """Per-session temporal gating state (one per :class:`StreamSession`).

    Single-task confinement, not locks: ``check``/``note_submitted``
    run on the session's reader task and ``note_computed``/
    ``materialize`` on its writer task, both on the same asyncio event
    loop thread — no concurrent access is possible, so the state below
    is deliberately unlocked. ``materialize`` may additionally run on
    an executor thread *on the writer task's behalf* (the full-frame
    warp is too heavy for the event loop — asynclint R201): that stays
    race-free because it only reads the writer-confined fields
    (``_enhanced``/``_flags``/``_computed_seq``) and the writer task is
    suspended awaiting it, while the reader task touches only its own
    fields (``_small``/``_shape``/``_anchor_seq``/``_run``).

    Protocol (see module docstring for why decision and answer are
    split): the reader calls ``check(rgb)`` per frame — ``None`` means
    compute (and, once the frame is actually submitted to the batcher,
    ``note_submitted(rgb, seq)`` makes it the new anchor); a decision
    tuple means reuse. The writer calls ``note_computed(seq, enhanced,
    flags)`` when it delivers a computed frame and
    ``materialize(decision)`` when it reaches a reuse child —
    ``(enhanced, flags)`` to replay, or ``None`` when the child's
    anchor never delivered.
    """

    def __init__(
        self,
        threshold: float,
        max_reuse_run: int = DEFAULT_MAX_REUSE_RUN,
        warp: bool = False,
    ):
        if threshold < 0:
            raise ValueError(f"reuse threshold must be >= 0, got {threshold}")
        if max_reuse_run < 1:
            raise ValueError(
                f"max_reuse_run must be >= 1, got {max_reuse_run}"
            )
        self.threshold = float(threshold)
        self.max_reuse_run = int(max_reuse_run)
        self.warp = bool(warp)
        self._small: Optional[np.ndarray] = None  # decimated anchor
        self._shape = None  # raw shape of the anchor frame
        self._anchor_seq: Optional[int] = None  # last submitted frame
        self._run = 0  # consecutive reuse decisions since the anchor
        self._enhanced: Optional[np.ndarray] = None  # last delivered
        self._flags = 0  # record flags the delivered frame carried
        self._computed_seq: Optional[int] = None  # its sequence number

    def check(
        self, rgb: np.ndarray
    ) -> Optional[Tuple[float, float, int]]:
        """Gate one incoming frame: a ``(dx, dy, anchor_seq)`` reuse
        decision (full-resolution backward flow, ``(0, 0)`` for a
        static scene) when it may be answered from the anchor's output,
        ``None`` when it must be computed (no anchor yet, resolution
        change, scene change, or the staleness cap)."""
        if self._small is None or rgb.shape != self._shape:
            return None
        if self._run >= self.max_reuse_run:
            return None
        small = decimate(rgb)
        if self.warp:
            score, (dx, dy) = block_flow(self._small, small)
        else:
            score, (dx, dy) = delta_score(self._small, small), (0, 0)
        if score > self.threshold:
            return None
        self._run += 1
        # Decimated-grid offset -> full-resolution pixels: the stride
        # the thumbnail was sampled with scales the motion.
        h, w = self._shape[:2]
        return (
            float(dx * max(1, w // DECIMATED_EDGE)),
            float(dy * max(1, h // DECIMATED_EDGE)),
            self._anchor_seq,
        )

    def note_submitted(self, rgb: np.ndarray, seq: int) -> None:
        """Record a frame submitted for compute as the new anchor."""
        self._small = decimate(rgb)
        self._shape = rgb.shape
        self._anchor_seq = int(seq)
        self._run = 0

    def note_computed(
        self, seq: int, enhanced: np.ndarray, flags: int = 0
    ) -> None:
        """Record a delivered computed frame's output (writer side)."""
        self._enhanced = enhanced
        self._flags = int(flags)
        self._computed_seq = int(seq)

    def materialize(
        self, decision: Tuple[float, float, int]
    ) -> Optional[Tuple[np.ndarray, int]]:
        """The cached ``(enhanced, flags)`` answer for a reuse decision
        (warped when the decision carries motion), or ``None`` when the
        decision's anchor never delivered — it was dropped or errored
        before its turn, so the cached output belongs to an older scene
        and replaying it would show the wrong content."""
        dx, dy, anchor_seq = decision
        if self._enhanced is None or self._computed_seq != anchor_seq:
            return None
        out = self._enhanced
        if dx or dy:
            out = shift_frame(out, dx, dy)
        return out, self._flags


class ResponseCache:
    """Bounded LRU over fully rendered ``/enhance`` answers.

    Keys are built by :meth:`key` from (payload digest, tier, the
    ladder identity fixed at construction, the current params
    generation); values are whatever the owner stores (the worker
    stores the response PNG, the fleet router a (ctype, headers, body)
    triple). ``invalidate()`` bumps the generation and clears the
    table — a ``put`` that raced a reload carries the old generation in
    its key and is refused, so stale-weights answers can never enter.

    Thread-safe: the front door's executor threads and the reload
    thread all touch it.
    """

    def __init__(self, capacity: int, ladder_id: str = ""):
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.ladder_id = str(ladder_id)
        self._lock = threading.Lock()
        self._entries = OrderedDict()  # guarded-by: self._lock
        self._generation = 0  # guarded-by: self._lock
        self._hits = 0  # guarded-by: self._lock
        self._misses = 0  # guarded-by: self._lock
        self._evictions = 0  # guarded-by: self._lock

    @staticmethod
    def digest(payload: bytes) -> str:
        return hashlib.sha256(payload).hexdigest()

    def key(self, payload: bytes, tier: str) -> tuple:
        with self._lock:
            gen = self._generation
        return (self.digest(payload), str(tier), self.ladder_id, gen)

    def get(self, key: tuple):
        """Stored value for ``key`` (bumped to most-recently-used), or
        None. Every call counts as a hit or a miss."""
        with self._lock:
            val = self._entries.get(key)
            if val is None:
                self._misses += 1
                return None
            self._entries.move_to_end(key)
            self._hits += 1
            return val

    def put(self, key: tuple, value) -> None:
        with self._lock:
            if key[-1] != self._generation:
                return  # computed under pre-reload params: refuse
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self._evictions += 1

    def invalidate(self) -> int:
        """Drop everything and bump the params generation (the
        ``/admin/reload`` hook). Returns the new generation."""
        with self._lock:
            self._generation += 1
            self._entries.clear()
            return self._generation

    def counters(self) -> dict:
        """The ``cache`` block of ``/stats`` (docs/SERVING.md)."""
        with self._lock:
            return {
                "enabled": True,
                "hits": self._hits,
                "misses": self._misses,
                "evictions": self._evictions,
                "entries": len(self._entries),
                "capacity": self.capacity,
                "generation": self._generation,
            }


def empty_cache_block() -> dict:
    """The ``cache`` stats block for a server with no cache configured —
    same keys as :meth:`ResponseCache.counters`, all zeros."""
    return {
        "enabled": False,
        "hits": 0,
        "misses": 0,
        "evictions": 0,
        "entries": 0,
        "capacity": 0,
        "generation": 0,
    }
