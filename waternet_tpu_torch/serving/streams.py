"""Stream sessions: live video over the serving front door.

The JAX package's ``serving/streams.py``, lifted; the wire protocol
below is byte-compatible with it, so one ``run_stream_load`` client
drives either package's server.

A client opens a session with ``POST /stream`` and uploads
length-prefixed frames on the same connection the enhanced frames come
back on — stdlib framing over the stdlib HTTP server, no new protocol
dependency. The :class:`StreamManager` owns admission (the third rung
of the degradation ladder) and one :class:`StreamSession` per open
connection; each session is two asyncio tasks over the shared
:class:`~waternet_tpu_torch.serving.batcher.DynamicBatcher`:

* the **reader** pulls frames off the socket, decodes them in the
  executor, and submits them to the batcher with a freshness deadline
  derived from the stream's declared fps budget — frames ride the same
  smallest-viable-bucket path as ``/enhance`` requests, so stream
  traffic compiles nothing (the compile-sentinel guarantee holds);
* the **writer** delivers results strictly in submit order, one record
  per frame — a frame that could not be delivered becomes an explicit
  drop or error record with a reason, never a silent gap and never a
  reorder.

Per-stream QoS policies, each deterministically fault-testable via
``WATERNET_FAULTS`` (``stream_stall@K`` / ``stream_disconnect@K`` /
``frame_corrupt@K``):

* **In-order delivery**: the session deque is FIFO in read order;
  the replica pool's crash/hang re-dispatch may complete batches out of order, but
  the writer always resolves the head frame first.
* **Bounded latency**: each frame's deadline is ``read time + budget``;
  a frame whose budget runs out is dropped *un-computed* by the batcher
  (``D`` record, reason ``budget``). When more than ``window`` frames
  are awaiting delivery, the oldest pending frame is dropped under the
  explicit drop-oldest policy (reason ``window``) — drop records are
  delivered in sequence position, never mid-reorder.
* **Stall/fault isolation**: a wedged client backpressures only its own
  session — past ``4 x window`` buffered frames the reader stops
  reading (TCP backpressure on that one connection); decode failures
  error only their own frame (``E`` record); a disconnect abandons that
  session's queued frames (the dispatcher and re-dispatch path drop
  them un-computed via ``RequestCancelled``) without touching
  batch-mates from other streams.
* **Degradation ladder**: (1) opted-in streams brown-out to the fast
  CAN tier per frame (``FLAG_DOWNGRADED`` on the record); (2) frame
  dropping holds latency; (3) new sessions are refused with 503 +
  Retry-After while established streams keep their QoS.
* **Temporal reuse** (off by default; ``X-Stream-Reuse`` or the
  server's ``--stream-reuse-threshold`` enables it): a frame whose
  decimated delta against the last frame *submitted for compute* (the
  anchor — submission-time anchoring is what lets reuse fire under
  backlog) is at or below the threshold is answered from the anchor's
  enhanced frame WITHOUT entering the batcher — an ``R`` record
  carrying ``FLAG_REUSED`` (byte-identical to a recompute for a delta
  of zero), bounded by the ``max_reuse_run`` staleness cap. If the
  anchor itself never delivered (dropped/errored), its reuse children
  become ``anchor`` drops rather than replaying the wrong scene
  (``serving/reuse.py``).

Wire protocol (all integers network byte order):

* upload: per frame a 4-byte big-endian length then that many bytes of
  JPEG/PNG; length 0 ends the stream cleanly.
* download: per record a 10-byte header ``!cBII`` = (kind, flags,
  seq, payload_len) then the payload. Kinds: ``F`` enhanced PNG frame;
  ``R`` reused PNG frame (temporal gating answered it from the
  session's cached enhanced frame); ``D`` drop notice (JSON
  ``{"reason": ...}``); ``E`` frame error (JSON); ``Z`` end-of-stream
  session summary (JSON). Flag bit 0 (``FLAG_DOWNGRADED``) marks a
  frame served by the fast tier; bit 1 (``FLAG_REUSED``) marks a
  reused frame.
"""

from __future__ import annotations

import asyncio
import json
import struct
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from waternet_tpu_torch.obs import trace
from waternet_tpu_torch.resilience import faults
from waternet_tpu_torch.serving.batcher import (
    DeadlineExpired,
    QueueFull,
    RequestCancelled,
)
from waternet_tpu_torch.serving.reuse import DEFAULT_MAX_REUSE_RUN, FrameDeltaGate
from waternet_tpu_torch.serving.stats import LATENCY_RESERVOIR, _percentile

#: Upload framing: one 4-byte big-endian payload length per frame.
FRAME_LEN = struct.Struct("!I")
#: Download framing: (kind, flags, seq, payload_len) per record.
REC_HEAD = struct.Struct("!cBII")

KIND_FRAME = b"F"
KIND_REUSED = b"R"
KIND_DROP = b"D"
KIND_ERROR = b"E"
KIND_END = b"Z"

#: Record flag bit: this frame was served by the fast tier under
#: brown-out (the stream opted in via X-Tier-Allow-Downgrade).
FLAG_DOWNGRADED = 1
#: Record flag bit: this frame was answered from the session's cached
#: enhanced frame by temporal gating (reuse.py) — never computed. A
#: reused copy of a downgraded frame carries both bits.
FLAG_REUSED = 2

#: One frame above this is a protocol error (the per-request front door
#: caps bodies the same way): refuse loudly instead of buffering it.
MAX_FRAME_BYTES = 16 << 20

#: The reader stops reading (TCP backpressure on that one connection)
#: once this many frames are buffered for a session that is not
#: consuming: the stall-isolation bound on per-session memory.
HARD_CAP_WINDOWS = 4


class StreamConfig:
    """Per-session QoS contract, parsed once from the request headers.

    ``X-Stream-Fps`` declares the paced rate (default 10); the
    freshness budget defaults to three frame intervals
    (``3000 / fps`` ms) and is overridden with ``X-Stream-Budget-Ms``.
    ``X-Tier`` / ``X-Tier-Allow-Downgrade`` mean exactly what they mean
    on ``/enhance``; ``X-Stream-Window`` bounds the frames awaiting
    delivery before drop-oldest fires (default: the server's
    ``--stream-window``). ``X-Stream-Reuse`` sets the temporal-gating
    delta threshold for this session (``off`` disables it even when the
    server default enables it; absent inherits the server's
    ``--stream-reuse-threshold``, itself off by default);
    ``X-Stream-Max-Reuse-Run`` caps consecutive reuses and
    ``X-Stream-Reuse-Warp`` enables the coarse block-flow pan
    compensation. Raises ValueError on malformed values — the front
    door answers 400."""

    def __init__(self, fps, budget_ms, tier, allow_downgrade, window,
                 reuse_threshold=None,
                 max_reuse_run=DEFAULT_MAX_REUSE_RUN,
                 reuse_warp=False):
        self.fps = fps
        self.budget_ms = budget_ms
        self.tier = tier
        self.allow_downgrade = allow_downgrade
        self.window = window
        self.reuse_threshold = reuse_threshold
        self.max_reuse_run = max_reuse_run
        self.reuse_warp = reuse_warp

    @classmethod
    def from_headers(
        cls,
        headers: dict,
        default_window: int,
        default_reuse: Optional[float] = None,
        default_max_reuse_run: int = DEFAULT_MAX_REUSE_RUN,
    ):
        fps = float(headers.get("x-stream-fps", "10"))
        if not fps > 0:
            raise ValueError(f"X-Stream-Fps must be > 0, got {fps}")
        budget_ms = float(
            headers.get("x-stream-budget-ms", str(3000.0 / fps))
        )
        if not budget_ms > 0:
            raise ValueError(
                f"X-Stream-Budget-Ms must be > 0, got {budget_ms}"
            )
        window = int(headers.get("x-stream-window", str(default_window)))
        if window < 1:
            raise ValueError(f"X-Stream-Window must be >= 1, got {window}")
        tier = headers.get("x-tier", "quality").strip().lower()
        allow_downgrade = headers.get(
            "x-tier-allow-downgrade", ""
        ).strip().lower() in ("1", "true", "yes")
        raw_reuse = headers.get("x-stream-reuse")
        if raw_reuse is None:
            reuse = default_reuse
        elif raw_reuse.strip().lower() in ("off", "none", ""):
            reuse = None
        else:
            reuse = float(raw_reuse)  # ValueError -> 400, like the rest
            if reuse < 0:
                raise ValueError(
                    f"X-Stream-Reuse must be >= 0 or 'off', got {reuse}"
                )
        max_run = int(
            headers.get(
                "x-stream-max-reuse-run", str(default_max_reuse_run)
            )
        )
        if max_run < 1:
            raise ValueError(
                f"X-Stream-Max-Reuse-Run must be >= 1, got {max_run}"
            )
        reuse_warp = headers.get(
            "x-stream-reuse-warp", ""
        ).strip().lower() in ("1", "true", "yes")
        return cls(
            fps, budget_ms, tier, allow_downgrade, window,
            reuse_threshold=reuse, max_reuse_run=max_run,
            reuse_warp=reuse_warp,
        )


class _Frame:
    """One in-flight frame of one session, from socket read to record
    written. Exactly one terminal state: delivered (``future`` result),
    reused (``reused`` holds the cached enhanced frame), dropped
    (``dropped`` holds the reason), or errored (``error``)."""

    __slots__ = (
        "seq", "t_read", "future", "dropped", "error", "delivering",
        "reused",
    )

    def __init__(self, seq: int, t_read: float):
        self.seq = seq
        self.t_read = t_read
        self.future = None  # batcher Future once submitted
        self.dropped: Optional[str] = None
        self.error: Optional[str] = None
        # The writer marks the head frame while awaiting/encoding it;
        # drop-oldest must never evict a frame mid-delivery.
        self.delivering = False
        # Temporal gating (reuse.py): the gate's reuse decision tuple
        # when the reader gated this frame out of compute; the writer
        # materializes the cached enhanced frame from it at delivery.
        self.reused = None


class StreamSession:
    """One open stream: a FIFO of :class:`_Frame` entries between a
    reader task and a writer task (see the module docstring for the
    policies; the manager owns admission and the registry)."""

    def __init__(self, sid, mgr, cfg, reader, writer, request_id=None):
        self.sid = sid
        self.mgr = mgr
        self.cfg = cfg
        self.reader = reader
        self.writer = writer
        # Correlation id for the whole session (the X-Request-Id the
        # front door echoed); per-frame spans use "<id>/<seq>".
        self.req_id = request_id or sid
        self.entries: deque = deque()
        self.progress = asyncio.Event()  # writer wake: new entry/state
        self.space = asyncio.Event()  # reader wake: room under hard cap
        self.dead = False  # connection gone: stop both loops
        self.read_done = False
        fault = faults.stream_session_fault()
        self.stall = fault.stall
        self.disconnect_after = fault.disconnect_after
        # Session accounting (the Z record and the /stats probe).
        self.frames_in = 0
        self.delivered = 0
        self.reused = 0
        self.dropped = 0
        self.out_of_budget = 0
        self.errors = 0
        self.downgraded = 0
        self.lat_s: List[float] = []  # delivered-frame latency sample
        # Temporal gating (off unless the session/server enabled it):
        # reader task checks, writer task anchors — same event loop,
        # so the gate needs no lock. The one exception is materialize,
        # which the writer task awaits on an executor thread (the warp
        # is too heavy for the loop); see FrameDeltaGate's docstring
        # for why that stays race-free.
        self.gate = (
            FrameDeltaGate(
                cfg.reuse_threshold,
                max_reuse_run=cfg.max_reuse_run,
                warp=cfg.reuse_warp,
            )
            if cfg.reuse_threshold is not None
            else None
        )

    # -- reader --------------------------------------------------------

    async def _read_len(self) -> Optional[int]:
        """Next frame length, None on clean end (length 0, EOF, or a
        server drain — sessions stop accepting frames so the drain's
        grace window is spent finishing work, not waiting on sockets)."""
        while True:
            if self.dead or self.mgr.draining.is_set():
                return None
            try:
                raw = await asyncio.wait_for(
                    self.reader.readexactly(FRAME_LEN.size), timeout=0.25
                )
            except asyncio.TimeoutError:
                continue  # re-check draining; readexactly keeps buffer
            except (asyncio.IncompleteReadError, ConnectionError):
                return None
            n = FRAME_LEN.unpack(raw)[0]
            return None if n == 0 else n

    async def run_reader(self) -> None:
        loop = asyncio.get_running_loop()
        try:
            while not self.dead:
                n = await self._read_len()
                if n is None:
                    break
                if n > MAX_FRAME_BYTES:
                    raise ConnectionResetError("oversized frame")
                try:
                    payload = await self.reader.readexactly(n)
                except (asyncio.IncompleteReadError, ConnectionError):
                    raise ConnectionResetError("mid-frame EOF")
                entry = _Frame(self.frames_in, time.perf_counter())
                self.frames_in += 1
                self.mgr.stats.record_stream_frame_in()
                # Stall-isolation hard cap: a session whose client is
                # not consuming stops READING too — backpressure lands
                # on this one connection's TCP window, never on the
                # batcher or on other sessions.
                while (
                    len(self.entries) >= HARD_CAP_WINDOWS * self.cfg.window
                    and not self.dead
                ):
                    self.space.clear()
                    await self.space.wait()
                if self.dead:
                    break
                if faults.frame_should_corrupt():
                    rgb = None
                else:
                    rgb = await loop.run_in_executor(
                        None, self.mgr.decode, payload
                    )
                if rgb is None:
                    # Decode failure quarantines ONLY this frame: an E
                    # record in sequence position, and the stream lives.
                    entry.error = "frame is not a decodable image"
                else:
                    if self.gate is not None:
                        # Temporal gating: a frame the gate recognises
                        # is answered from the anchor's enhanced frame
                        # at delivery and never enters the batcher
                        # (reuse.py — the anchor is the last SUBMITTED
                        # frame, so reuse works even under backlog).
                        entry.reused = self.gate.check(rgb)
                if rgb is not None and entry.reused is None:
                    deadline = entry.t_read + self.cfg.budget_ms / 1e3
                    try:
                        entry.future = self.mgr.batcher.submit(
                            rgb,
                            deadline=deadline,
                            tier=self.cfg.tier,
                            allow_downgrade=self.cfg.allow_downgrade,
                            request_id=f"{self.req_id}/{entry.seq}",
                        )
                        if self.gate is not None:
                            self.gate.note_submitted(rgb, entry.seq)
                    except QueueFull:
                        entry.dropped = "queue"
                    except DeadlineExpired:
                        # Budget already burned before admission (the
                        # session fell that far behind): an explicit
                        # budget drop, NOT a dead batcher — both are
                        # RuntimeError subclasses, so order matters here.
                        entry.dropped = "budget"
                    except RuntimeError:
                        break  # batcher closed under us: drain finished
                self.entries.append(entry)
                self._enforce_window()
                self.progress.set()
                if (
                    self.disconnect_after is not None
                    and self.frames_in >= self.disconnect_after
                ):
                    raise ConnectionResetError("injected stream_disconnect")
        except ConnectionResetError:
            self.dead = True
        finally:
            self.read_done = True
            self.progress.set()

    def _enforce_window(self) -> None:
        """Drop-oldest: past ``window`` frames awaiting delivery, the
        oldest pending frame (never the one the writer is mid-delivery
        on) becomes an explicit ``window`` drop; its future is marked
        abandoned so the batcher drops the compute too."""
        # Reused entries are already answered (no compute pending), so
        # they never count against the window and are never evicted —
        # drop-oldest exists to shed queued COMPUTE, not finished work.
        live = [
            e for e in self.entries
            if e.dropped is None and e.error is None and e.reused is None
        ]
        while len(live) > self.cfg.window:
            victim = next(
                (e for e in live if not e.delivering), None
            )
            if victim is None:
                return
            victim.dropped = "window"
            if victim.future is not None:
                victim.future.abandoned = True
            live.remove(victim)

    # -- writer --------------------------------------------------------

    async def _write_record(self, kind, flags, seq, payload) -> None:
        if self.stall:
            # Injected wedged consumer: every delivery stalls, so the
            # window fills, drop-oldest fires, and eventually the hard
            # cap pauses the reader — all visible to the fault tests.
            await asyncio.sleep(faults.stream_stall_sec())
        self.writer.write(REC_HEAD.pack(kind, flags, seq, len(payload)))
        self.writer.write(payload)
        await self.writer.drain()

    def _trace_frame(self, entry: _Frame, downgraded: bool = False) -> None:
        """Frame lifecycle span: socket read ->
        terminal record written, with the drop/downgrade annotation
        inline — a Perfetto view of a stream shows which frames paid
        what, and why the gaps are gaps."""
        if not trace.enabled():
            return
        trace.record_span(
            "stream_frame", "serving", entry.t_read, time.perf_counter(),
            args={
                "request_id": f"{self.req_id}/{entry.seq}",
                "stream": self.sid,
                "seq": entry.seq,
                "dropped": entry.dropped,
                "downgraded": downgraded,
                "error": entry.error,
            },
        )

    async def _deliver(self, entry: _Frame) -> None:
        loop = asyncio.get_running_loop()
        if entry.reused is not None:
            # The warped replay is full-resolution numpy work (R201:
            # shift_frame is declared loop-blocking), so it runs on the
            # executor. Safe off-loop: materialize reads only the
            # writer-confined fields (_enhanced/_flags/_computed_seq)
            # and this writer task is suspended until it returns.
            hit = await loop.run_in_executor(
                None, self.gate.materialize, entry.reused
            )
            if hit is not None:
                # Temporal reuse: answer from the anchor's enhanced
                # frame — encode and write the R record (byte-identical
                # to a recompute for a delta of zero; the PNG encoder is
                # deterministic on the identical array). The downgrade
                # bit, if any, is inherited from the anchor frame.
                out, anchor_flags = hit
                flags = FLAG_REUSED | anchor_flags
                png = await loop.run_in_executor(
                    None, self.mgr.encode, out
                )
                await self._write_record(
                    KIND_REUSED, flags, entry.seq, png
                )
                self.reused += 1
                self.mgr.stats.record_stream_frame_reused()
                if trace.enabled():
                    # A distinct span name keeps reused frames out of
                    # the device stage in the trace CLI's per-stage
                    # table — they never touched a replica.
                    trace.record_span(
                        "frame_reuse", "serving", entry.t_read,
                        time.perf_counter(),
                        args={
                            "request_id": f"{self.req_id}/{entry.seq}",
                            "stream": self.sid,
                            "seq": entry.seq,
                            "downgraded": bool(flags & FLAG_DOWNGRADED),
                        },
                    )
                return
            # The decision's anchor never delivered (dropped or
            # errored before its turn): the cached output belongs to
            # an older scene, so replaying it would show the wrong
            # content. An honest drop instead.
            entry.dropped = "anchor"
        if entry.dropped is None and entry.error is None:
            try:
                out = await asyncio.wrap_future(entry.future)
            except DeadlineExpired:
                entry.dropped = "budget"
            except RequestCancelled:
                entry.dropped = (
                    "window" if getattr(
                        entry.future, "abandoned", False
                    ) else "cancelled"
                )
            except Exception as err:
                entry.error = f"{type(err).__name__}: {err}"
        if entry.error is not None:
            self.errors += 1
            await self._write_record(
                KIND_ERROR, 0, entry.seq,
                json.dumps({"error": entry.error}).encode(),
            )
            self._trace_frame(entry)
            return
        if entry.dropped is not None:
            self.mgr.stats.record_stream_drop(entry.dropped)
            if entry.dropped == "budget":
                self.out_of_budget += 1
            else:
                self.dropped += 1
            await self._write_record(
                KIND_DROP, 0, entry.seq,
                json.dumps({"reason": entry.dropped}).encode(),
            )
            self._trace_frame(entry)
            return
        served = getattr(entry.future, "tier", self.cfg.tier)
        flags = 0
        if served != self.cfg.tier:
            flags |= FLAG_DOWNGRADED
            self.downgraded += 1
            self.mgr.stats.record_stream_downgrade()
        if self.gate is not None:
            # Record the delivered output so this frame's reuse
            # children (gated while it was still in flight) can
            # materialize it — inheriting the downgrade bit, so a
            # browned-out anchor never masquerades as quality.
            self.gate.note_computed(entry.seq, out, flags)
        png = await loop.run_in_executor(None, self.mgr.encode, out)
        await self._write_record(KIND_FRAME, flags, entry.seq, png)
        span = time.perf_counter() - entry.t_read
        self.delivered += 1
        self.lat_s.append(span)
        if len(self.lat_s) > LATENCY_RESERVOIR:
            del self.lat_s[0]
        self.mgr.stats.record_stream_frame_delivered(span)
        self._trace_frame(entry, downgraded=bool(flags & FLAG_DOWNGRADED))

    async def run_writer(self) -> None:
        try:
            while True:
                while not self.entries:
                    if self.read_done or self.dead:
                        return
                    self.progress.clear()
                    await self.progress.wait()
                if self.dead:
                    return
                entry = self.entries[0]
                entry.delivering = True
                await self._deliver(entry)
                self.entries.popleft()
                self.space.set()
        except (ConnectionError, asyncio.IncompleteReadError):
            self.dead = True
            self.space.set()

    # -- lifecycle -----------------------------------------------------

    def summary(self) -> dict:
        return {
            "stream_id": self.sid,
            "frames_in": self.frames_in,
            "delivered": self.delivered,
            "reused": self.reused,
            "dropped": self.dropped,
            "out_of_budget": self.out_of_budget,
            "errors": self.errors,
            "downgraded": self.downgraded,
        }

    def p99_ms(self) -> float:
        return round(_percentile(sorted(self.lat_s), 0.99) * 1e3, 3)

    async def run(self) -> None:
        reader_task = asyncio.ensure_future(self.run_reader())
        try:
            await self.run_writer()
        finally:
            if not self.read_done:
                # The writer bailed (connection gone) while the reader
                # was still reading: the session is dead, not clean.
                self.dead = True
            self.space.set()
            self.progress.set()
            await reader_task
            self._abandon_pending()
        if not self.dead:
            try:
                await self._write_record(
                    KIND_END, 0, self.frames_in,
                    json.dumps(self.summary()).encode(),
                )
            except (ConnectionError, asyncio.IncompleteReadError):
                pass

    def _abandon_pending(self) -> None:
        """Disconnect cleanup: every queued frame of THIS session is
        abandoned (the batcher/redispatch paths drop them un-computed)
        and accounted as a disconnect drop — batch-mates from other
        sessions are untouched."""
        while self.entries:
            e = self.entries.popleft()
            if e.future is not None and not e.future.done():
                e.future.abandoned = True
            if e.dropped is None and e.error is None:
                self.mgr.stats.record_stream_drop("disconnect")
                self.dropped += 1
        self.space.set()


class StreamManager:
    """Admission + registry for stream sessions (one per server).

    Admission is the third rung of the degradation ladder: a NEW
    session is refused with 503 + Retry-After when ``max_streams``
    sessions are already open or the batcher queue sits at/past the
    admit watermark — established streams keep their windows, budgets,
    and (opted-in) brown-out; refusal never touches them. Decode and
    encode are injected callables (the front door's cv2 helpers) so
    this module never imports the server."""

    def __init__(
        self,
        batcher,
        stats,
        max_streams: int,
        window: int,
        admit_watermark: int,
        decode,
        encode,
        draining: threading.Event,
    ):
        self.batcher = batcher
        self.stats = stats
        self.max_streams = int(max_streams)
        self.window = int(window)
        self.admit_watermark = int(admit_watermark)
        self.decode = decode
        self.encode = encode
        self.draining = draining
        self._lock = threading.Lock()
        self._sessions: Dict[str, StreamSession] = {}  # guarded-by: self._lock
        self._next_id = 0  # guarded-by: self._lock
        stats.stream_probe = self._probe

    def active_count(self) -> int:
        with self._lock:
            return len(self._sessions)

    def _probe(self) -> dict:
        """The live gauge ``stats.summary()`` reads (any thread)."""
        with self._lock:
            sessions = list(self._sessions.values())
        return {
            "active_streams": len(sessions),
            "per_session_p99_ms": {
                s.sid: s.p99_ms() for s in sessions
            },
        }

    def refusal(self) -> Optional[str]:
        """Why a NEW session cannot be admitted right now (None = admit).
        Counted by the caller via ``stats.record_stream_refused``."""
        if self.active_count() >= self.max_streams:
            return (
                f"stream limit reached ({self.max_streams} sessions open)"
            )
        if self.batcher.queue_depth() >= self.admit_watermark:
            return "pool saturated (queue at admission watermark)"
        return None

    async def handle(
        self, cfg: StreamConfig, reader, writer, request_id=None
    ) -> None:
        """Run one admitted session to completion (the front door has
        already validated tier/headers and written the response head)."""
        with self._lock:
            self._next_id += 1
            sid = f"s{self._next_id}"
            session = StreamSession(
                sid, self, cfg, reader, writer, request_id=request_id
            )
            self._sessions[sid] = session
        self.stats.record_stream_open()
        t_open = time.perf_counter() if trace.enabled() else None
        try:
            await session.run()
        finally:
            with self._lock:
                self._sessions.pop(sid, None)
            if t_open is not None:
                trace.record_span(
                    "stream_session", "serving", t_open,
                    time.perf_counter(),
                    args=dict(session.summary(),
                              request_id=session.req_id),
                )
