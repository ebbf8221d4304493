"""The port's video stream (``waternet_tpu_torch.data.video``) on the CPU,
against the JAX package's ``waternet_tpu.data.video``.

Decode is the same cv2 in both packages, so the decoded frames and the
ingest counts are held equal. The enhanced frames are held to the
engines' bounds (tests/test_torch_engine.py): with host preprocessing
the network's inputs are bit-identical (cv2 in both), but the fp32
forwards round differently (~1e-6: oneDNN against XLA), which moves a
truncated uint8 value by one on a few values in 100,000 (one value on
the 11-frame clip below): within one level on at most 0.1% of values.
With device preprocessing the LAB inverse adds its one level: within one
level on under 1% of values. Against the port's own engine on the same
decoded, padded batches the stream is bit for bit.
"""

import threading

import cv2
import numpy as np
import pytest

from waternet_tpu.data.video import enhance_video_stream as jax_stream
from waternet_tpu.inference_engine import InferenceEngine as JaxEngine
from waternet_tpu.resilience import faults
from waternet_tpu_torch.data.pipeline import THREAD_PREFIX
from waternet_tpu_torch.data.video import _read_batch, _read_batches, enhance_video_stream
from waternet_tpu_torch.inference_engine import InferenceEngine

from test_torch_engine import TEACHER, frames

N_FRAMES, H, W = 11, 48, 64


def test_read_batch_skips_bad_frames_midstream():
    clip = [np.full((8, 8, 3), i, np.uint8) for i in range(10)]
    cap = faults.FaultInjectingCapture(clip, bad_indices=(3, 4))
    stats, got = {}, []
    while True:
        bgr, rgb = _read_batch(cap, 4, stats)
        if rgb is None:
            break
        got.extend(int(f[0, 0, 0]) for f in bgr)
    assert got == [0, 1, 2, 5, 6, 7, 8, 9]
    assert stats == {"frames_decoded": 8, "decode_failures": 2}


def test_read_batch_pads_the_tail_and_ends_at_eof():
    clip = [np.full((8, 8, 3), i, np.uint8) for i in range(3)]
    cap = faults.FaultInjectingCapture(clip)
    bgr, rgb = _read_batch(cap, 4, {})
    assert len(bgr) == 3 and rgb.shape == (4, 8, 8, 3)
    np.testing.assert_array_equal(rgb[3], rgb[2])  # the last frame repeated
    assert _read_batch(cap, 4, {}) == ([], None)


class _Identity:
    def enhance_async(self, rgb):
        import torch

        return torch.from_numpy(rgb).float() / 255.0


def test_stream_warns_with_totals():
    clip = [np.full((8, 8, 3), i, np.uint8) for i in range(6)]
    cap = faults.FaultInjectingCapture(clip, bad_indices=(2,))
    stats = {}
    with pytest.warns(RuntimeWarning, match=r"skipped 1 undecodable frame\(s\) mid-stream \(5 decoded\)"):
        out = list(enhance_video_stream(_Identity(), cap, batch_size=2, stats=stats))
    assert len(out) == 5
    assert stats == {"frames_decoded": 5, "decode_failures": 1}


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """An 11-frame 64x48 mp4 (mp4v) of photo-like frames, each numbered."""
    path = tmp_path_factory.mktemp("video") / "v.mp4"
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter.fourcc(*"mp4v"), 5, (W, H))
    assert writer.isOpened()
    for i, f in enumerate(frames((N_FRAMES, H, W, 3), 7)):
        f = np.ascontiguousarray(f)
        cv2.putText(f, str(i), (5, 30), cv2.FONT_HERSHEY_DUPLEX, 1, (255, 255, 255))
        writer.write(f)
    writer.release()
    return path


@pytest.fixture(scope="module")
def engines():
    return {
        dp: (
            InferenceEngine(weights=TEACHER, device_preprocess=dp, device="cpu"),
            JaxEngine(weights=TEACHER, device_preprocess=dp),
        )
        for dp in (True, False)
    }


def run_stream(stream_fn, engine, path, **kw):
    cap = cv2.VideoCapture(str(path))
    stats = {}
    try:
        pairs = list(stream_fn(engine, cap, batch_size=4, stats=stats, **kw))
    finally:
        cap.release()
    return pairs, stats


@pytest.mark.parametrize("device_preprocess", [False, True], ids=["hostpre", "devpre"])
def test_stream_matches_jax_stream(clip, engines, device_preprocess):
    port, ref = engines[device_preprocess]
    got, got_stats = run_stream(enhance_video_stream, port, clip)
    want, want_stats = run_stream(jax_stream, ref, clip)
    assert len(got) == len(want) == N_FRAMES
    assert got_stats == want_stats == {"frames_decoded": N_FRAMES}
    for (g_in, g_out), (w_in, w_out) in zip(got, want):
        np.testing.assert_array_equal(g_in, w_in)
        assert g_out.dtype == np.uint8 and g_out.shape == (H, W, 3)
    outs = np.stack([o for _, o in got]).astype(np.int16)
    diff = np.abs(outs - np.stack([o for _, o in want]).astype(np.int16))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= (0.01 if device_preprocess else 0.001)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_stream_equals_the_engine_on_padded_batches(clip, engines, prefetch):
    """Frame order and count kept; every frame equal to ``engine.enhance``
    on the decoded batches, the tail padded to the batch size."""
    port = engines[True][0]
    got, _ = run_stream(enhance_video_stream, port, clip, prefetch=prefetch)
    cap = cv2.VideoCapture(str(clip))
    try:
        batches = list(_read_batches(cap, 4, {}))
    finally:
        cap.release()
    assert [len(b) for b, _ in batches] == [4, 4, 3]
    assert all(rgb.shape == (4, H, W, 3) for _, rgb in batches)
    want = [(bgr, out) for b, rgb in batches for bgr, out in zip(b, port.enhance(rgb))]
    assert len(got) == len(want) == N_FRAMES
    for (g_in, g_out), (w_in, w_out) in zip(got, want):
        np.testing.assert_array_equal(g_in, w_in)
        np.testing.assert_array_equal(g_out, cv2.cvtColor(w_out, cv2.COLOR_RGB2BGR))


def test_prefetch_0_and_2_give_identical_frames(clip, engines):
    port = engines[False][0]
    a, _ = run_stream(enhance_video_stream, port, clip, prefetch=0)
    b, _ = run_stream(enhance_video_stream, port, clip, prefetch=2)
    assert len(a) == len(b) == N_FRAMES
    for (ai, ao), (bi, bo) in zip(a, b):
        np.testing.assert_array_equal(ai, bi)
        np.testing.assert_array_equal(ao, bo)


def test_stream_stops_its_decoder_when_the_consumer_stops_early(clip):
    cap = cv2.VideoCapture(str(clip))
    try:
        stream = enhance_video_stream(_Identity(), cap, batch_size=2, prefetch=2)
        first = [next(stream) for _ in range(3)]
        stream.close()
    finally:
        cap.release()
    assert len(first) == 3
    assert not [t for t in threading.enumerate() if t.name.startswith(THREAD_PREFIX) and t.is_alive()]
