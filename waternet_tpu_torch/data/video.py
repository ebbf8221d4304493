"""Pipelined video enhancement, the port of the JAX package's
``data/video.py``.

Frames go through the engine in batches, double buffered: batch N+1 is
enqueued on the device before the host waits for batch N's result, so
the upload, the transforms and the forward of one batch overlap the
readback and the frame writing of the one before (the engine uploads
through pinned memory, so the enqueue does not wait for the device).

Decode runs ahead on a background thread
(:class:`waternet_tpu_torch.data.pipeline.PrefetchIterator`, bounded
depth): a capture decodes frame N before N+1, so decode cannot fan out,
but one producer keeps decoding while the consumer waits on the device
and writes frames. ``prefetch=0`` decodes inline on the consumer thread.
cv2 is imported by the functions that use it.
"""

from __future__ import annotations

import warnings
from typing import Iterator, Tuple

import numpy as np

from waternet_tpu_torch.utils.tensor import ten2arr


def _read_batch(cap, batch_size: int, stats: dict | None = None):
    """Read up to ``batch_size`` frames; -> (bgr_frames, rgb_array or None).

    A short final batch is padded (last frame repeated) up to
    ``batch_size``, so the device sees one shape for the whole clip: one
    cached CLAHE launch plan and one set of cuDNN plans. ``bgr_frames``
    keeps only the real frames; the caller drops the padded outputs by
    its length.

    ``cap.read()`` returning False is either the end of the stream or a
    mid-clip decode failure. A decode failure still advances
    ``CAP_PROP_POS_FRAMES`` (the container grab succeeded, the codec's
    retrieve failed), the end does not. Bad frames are skipped and counted
    in ``stats["decode_failures"]``; only a stalled position ends the
    stream. Backends that track no position degrade to treating the first
    failure as the end.
    """
    import cv2

    frames = []
    while len(frames) < batch_size:
        before = cap.get(cv2.CAP_PROP_POS_FRAMES)
        ok, bgr = cap.read()
        if ok and bgr is not None:
            frames.append(bgr)
            if stats is not None:
                stats["frames_decoded"] = stats.get("frames_decoded", 0) + 1
            continue
        if cap.get(cv2.CAP_PROP_POS_FRAMES) > before:
            # Progress without a frame: a mid-stream decode failure.
            if stats is not None:
                stats["decode_failures"] = stats.get("decode_failures", 0) + 1
            continue
        break  # no progress: the end of the stream
    if not frames:
        return [], None
    rgb = np.stack([cv2.cvtColor(f, cv2.COLOR_BGR2RGB) for f in frames])
    if len(frames) < batch_size:
        pad = np.repeat(rgb[-1:], batch_size - len(frames), axis=0)
        rgb = np.concatenate([rgb, pad], axis=0)
    return frames, rgb


def _read_batches(cap, batch_size: int, stats: dict):
    """Generator over (bgr_frames, rgb_array) batches until the end."""
    while True:
        frames, rgb = _read_batch(cap, batch_size, stats)
        if rgb is None:
            return
        yield frames, rgb


def enhance_video_stream(
    engine,
    cap,
    batch_size: int = 4,
    stats: dict | None = None,
    prefetch: int = 2,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (original_bgr, enhanced_bgr) frame pairs in order.

    ``engine`` is a :class:`waternet_tpu_torch.inference_engine.
    InferenceEngine` (anything with its ``enhance_async``); ``cap`` an
    opened ``cv2.VideoCapture``. Undecodable mid-stream frames are
    skipped (see :func:`_read_batch`); pass a ``stats`` dict to receive
    the counts. A ``RuntimeWarning`` with the totals is issued at the end
    whenever frames were dropped.

    With ``prefetch > 0`` decode runs on a background thread up to
    ``prefetch`` batches ahead; the thread is stopped and joined when the
    consumer stops early. ``prefetch=0`` decodes inline.
    """
    import cv2

    if stats is None:
        stats = {}

    def _finish():
        bad = stats.get("decode_failures", 0)
        if bad:
            good = stats.get("frames_decoded", 0)
            warnings.warn(
                f"video: skipped {bad} undecodable frame(s) mid-stream "
                f"({good} decoded). The clip is damaged; output omits the "
                "bad frames instead of truncating at the first one.",
                RuntimeWarning,
                stacklevel=3,
            )

    source = _read_batches(cap, batch_size, stats)
    if prefetch > 0:
        from waternet_tpu_torch.data.pipeline import PrefetchIterator

        source = PrefetchIterator(source, depth=prefetch, name="video")
    try:
        got = next(source, None)
        if got is None:
            _finish()
            return
        frames, pending = got[0], engine.enhance_async(got[1])
        while True:
            # Enqueue the next batch before waiting for this one.
            nxt = next(source, None)
            following = engine.enhance_async(nxt[1]) if nxt is not None else None
            out = ten2arr(pending)
            for bgr_in, rgb_out in zip(frames, out):
                yield bgr_in, cv2.cvtColor(rgb_out, cv2.COLOR_RGB2BGR)
            if nxt is None:
                _finish()
                return
            frames, pending = nxt[0], following
    finally:
        if prefetch > 0:
            source.close()
