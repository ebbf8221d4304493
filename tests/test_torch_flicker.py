"""The port's temporal flicker metric (``waternet_tpu_torch.metrics.
flicker``) against the JAX package's numpy one, on the synthetic-pan
cases of tests/test_flicker.py: known integer and fractional flows, the
identity flow, masking and the degenerate inputs.

Tolerance: ``warp`` runs the same float32 operations in the same order,
so the warped frames and masks are equal bit for bit. The errors are
means over many values, which numpy and torch sum in other orders: they
agree within rel 1e-6.
"""

import numpy as np
import pytest
import torch

from waternet_tpu.metrics import flicker as jax_flicker
from waternet_tpu_torch.metrics.flicker import flicker_index, identity_flow, warp, warped_error


def pan_frames(rng, n=4, hw=(24, 32), step=(3, 2)):
    """Sliding crops of one texture: the true backward flow is (sx, sy)."""
    h, w = hw
    sy, sx = step
    big = np.asarray(rng.integers(0, 256, (h + n * sy, w + n * sx, 3)), dtype=np.uint8)
    return [big[t * sy:t * sy + h, t * sx:t * sx + w] for t in range(n)], (sx, sy)


def const_flow(hw, dx, dy):
    flow = np.zeros((*hw, 2), dtype=np.float32)
    flow[..., 0] = dx
    flow[..., 1] = dy
    return flow


@pytest.mark.parametrize("dxdy", [(2, 3), (0.5, 0.0), (-1.25, 0.75), (0, 0)], ids=str)
@pytest.mark.parametrize("channels", [3, 0], ids=["hwc", "hw"])
def test_warp_equals_jax(rng, dxdy, channels):
    frames, _ = pan_frames(rng)
    prev = frames[0] if channels else frames[0][..., 0]
    flow = const_flow(prev.shape[:2], *dxdy)
    got, got_valid = warp(torch.from_numpy(prev), torch.from_numpy(flow))
    want, want_valid = jax_flicker.warp(prev, flow)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_valid.numpy(), want_valid)


def test_flicker_index_equals_jax_with_true_and_identity_flow(rng):
    frames, (sx, sy) = pan_frames(rng, n=5)

    def true_flow(prev, nxt):
        return const_flow(prev.shape[:2], sx, sy)

    tensors = [torch.from_numpy(f) for f in frames]
    assert flicker_index(tensors, flow_fn=true_flow) == pytest.approx(0.0, abs=1e-12)
    got = flicker_index(tensors)
    assert got > 1.0
    assert got == pytest.approx(jax_flicker.flicker_index(frames), rel=1e-6)

    swingy = [np.clip(f.astype(np.float32) + (25.0 if i % 2 else -25.0), 0, 255).astype(np.uint8)
              for i, f in enumerate(frames)]
    got_swing = flicker_index([torch.from_numpy(f) for f in swingy], flow_fn=true_flow)
    assert got_swing == pytest.approx(jax_flicker.flicker_index(swingy, flow_fn=true_flow), rel=1e-6)
    assert got_swing > 10.0


def test_warped_error_with_fractional_flow_equals_jax(rng):
    a, b = (np.asarray(rng.integers(0, 256, (9, 11, 3)), dtype=np.uint8) for _ in range(2))
    flow = const_flow((9, 11), 0.3, -0.6)
    got = warped_error(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(flow))
    assert got == pytest.approx(jax_flicker.warped_error(a, b, flow), rel=1e-6)
    assert warped_error(a, b) == pytest.approx(jax_flicker.warped_error(a, b), rel=1e-6)
    assert tuple(identity_flow(torch.from_numpy(a), torch.from_numpy(b)).shape) == (9, 11, 2)


def test_degenerate_inputs():
    a = torch.zeros((4, 4, 3), dtype=torch.uint8)
    assert flicker_index([]) == 0.0
    assert flicker_index([a]) == 0.0
    with pytest.raises(ValueError, match="shape"):
        warped_error(a, torch.zeros((5, 4, 3), dtype=torch.uint8))
    with pytest.raises(ValueError, match="flow shape"):
        warp(a, torch.zeros((4, 4, 3)))
    assert warped_error(a, a, const_flow((4, 4), 100.0, 100.0)) == 0.0
