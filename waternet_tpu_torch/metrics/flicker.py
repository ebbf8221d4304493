"""Temporal flicker: the warped frame-to-frame error of an enhanced video.

The port of the JAX package's ``metrics/flicker.py`` (numpy there), on
torch tensors on any device. Per-frame enhancement can be photometrically
unstable: two nearly identical input frames map to visibly different
outputs, which a viewer sees as flicker. The measure is the warped frame
difference: motion-compensate the previous frame with the inter-frame
flow, then take what changed beyond the motion.

``flicker_index(frames)`` is the mean over consecutive pairs of the
masked mean absolute error between ``warp(prev, flow)`` and ``next``: 0
for a video whose enhancement commutes with motion, larger the more it
swims. The flow is pluggable (``flow_fn(prev, next) -> (H, W, 2)`` dx/dy
in pixels); the default is the identity flow (the plain frame
difference), exact for a static camera and an upper bound otherwise.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch


def identity_flow(prev: torch.Tensor, nxt: torch.Tensor) -> torch.Tensor:
    """The zero flow: ``warp`` becomes the identity."""
    h, w = prev.shape[:2]
    return torch.zeros((h, w, 2), dtype=torch.float32, device=prev.device)


def warp(frame, flow) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward-warp ``frame`` by ``flow``; -> ``(warped, valid)``.

    ``flow[y, x] = (dx, dy)`` means the content at ``(x, y)`` in the next
    frame came from ``(x + dx, y + dy)`` in ``frame`` (backward mapping:
    every output pixel gets a value). Bilinear sampling; ``valid`` is
    False where the source falls outside the frame, and those pixels are
    left out of the error. ``warped`` is float32 in the input's value
    range; an (H, W) or (H, W, C) frame.
    """
    frame = torch.as_tensor(frame)
    flow = torch.as_tensor(flow, dtype=torch.float32, device=frame.device)
    h, w = frame.shape[:2]
    if tuple(flow.shape[:2]) != (h, w) or flow.shape[-1] != 2:
        raise ValueError(f"flow shape {tuple(flow.shape)} does not match frame {tuple(frame.shape)}")
    gy = torch.arange(h, dtype=torch.float32, device=frame.device)[:, None].expand(h, w)
    gx = torch.arange(w, dtype=torch.float32, device=frame.device)[None, :].expand(h, w)
    sx = gx + flow[..., 0]
    sy = gy + flow[..., 1]
    valid = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
    # Clamp for sampling; invalid pixels are masked out of the metric.
    sx = sx.clamp(0, w - 1)
    sy = sy.clamp(0, h - 1)
    x0 = sx.floor().long()
    y0 = sy.floor().long()
    x1 = (x0 + 1).clamp(max=w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    fx = sx - x0
    fy = sy - y0
    if frame.ndim == 3:
        fx = fx[..., None]
        fy = fy[..., None]
    f = frame.to(torch.float32)
    top = f[y0, x0] * (1.0 - fx) + f[y0, x1] * fx
    bot = f[y1, x0] * (1.0 - fx) + f[y1, x1] * fx
    return top * (1.0 - fy) + bot * fy, valid


def warped_error(prev, nxt, flow=None) -> float:
    """Masked mean absolute error between ``warp(prev, flow)`` and
    ``nxt``, the per-pair flicker term; ``flow=None`` is the identity
    flow. 0.0 when no pixel is valid."""
    prev = torch.as_tensor(prev)
    nxt = torch.as_tensor(nxt, device=prev.device)
    if prev.shape != nxt.shape:
        raise ValueError(f"frame shapes differ: {tuple(prev.shape)} vs {tuple(nxt.shape)}")
    if flow is None:
        flow = identity_flow(prev, nxt)
    warped, valid = warp(prev, flow)
    if not bool(valid.any()):
        return 0.0
    diff = (warped - nxt.to(torch.float32)).abs()
    if diff.ndim == 3:
        diff = diff.mean(dim=-1)
    return float(diff[valid].mean())


def flicker_index(frames: Sequence, flow_fn: Optional[Callable] = None) -> float:
    """Mean warped frame-to-frame error over consecutive pairs;
    ``flow_fn(prev, nxt) -> (H, W, 2)`` (default :func:`identity_flow`).
    0.0 for fewer than two frames."""
    frames = [torch.as_tensor(f) for f in frames]
    if len(frames) < 2:
        return 0.0
    if flow_fn is None:
        flow_fn = identity_flow
    errs = [warped_error(p, n, flow_fn(p, n)) for p, n in zip(frames[:-1], frames[1:])]
    return sum(errs) / len(errs)
