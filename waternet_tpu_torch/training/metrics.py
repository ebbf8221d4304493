"""Image quality metrics, SSIM and PSNR, with torchmetrics' semantics.

As the JAX package's ``training/metrics.py``:

* SSIM: an 11x11 gaussian window (sigma 1.5), k1 = 0.01, k2 = 0.03,
  ``data_range`` inferred as ``max(ptp(preds), ptp(target))`` over the
  whole batch when not given, the valid-window SSIM map, its per-image
  mean, then the (masked) batch mean. The window is a depthwise
  ``F.conv2d(groups=C)``.
* PSNR: ``10 log10(data_range^2 / mse)`` with one (masked) mean squared
  error over the batch.

Inputs are NHWC. An optional (N,) ``mask`` marks the real images of a
batch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _gaussian_window(kernel_size: int, sigma: float, channels: int, device: torch.device):
    """(C, 1, k, k) float32 depthwise gaussian window on ``device``, copied
    once per device (a copy from host memory in the step would make the
    host wait for the device's queued work). Made outside inference mode,
    since autograd saves it when the metric is differentiated."""
    ax = np.arange(kernel_size, dtype=np.float64) - (kernel_size - 1) / 2.0
    g = np.exp(-0.5 * (ax / sigma) ** 2)
    g = g / g.sum()
    k2d = np.outer(g, g).astype(np.float32)
    window = np.ascontiguousarray(np.broadcast_to(k2d, (channels, 1) + k2d.shape))
    with torch.inference_mode(False):
        # jaxlint: disable-next=R003 first-call table (lru_cache per device): a blocking copy, safe on every stream
        return torch.from_numpy(window).to(device)


def _depthwise_filter(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Valid depthwise 2D filter of an NCHW tensor."""
    return F.conv2d(x, window, groups=x.shape[1])


def masked_mean(per_image: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Mean of per-image scalars over the real (unmasked) images."""
    if mask is None:
        return per_image.mean()
    m = mask.to(torch.float32)
    return (per_image * m).sum() / torch.clamp_min(m.sum(), 1.0)


def ssim_per_image(
    preds: torch.Tensor,
    target: torch.Tensor,
    data_range: float | None = None,
    kernel_size: int = 11,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """(N,) per-image valid-window SSIM of NHWC batches."""
    preds = preds.to(torch.float32)
    target = target.to(torch.float32)
    if data_range is None:
        dr = torch.maximum(preds.max() - preds.min(), target.max() - target.min())
    elif torch.is_tensor(data_range):
        dr = data_range.to(torch.float32)
    else:
        # A fill on the device: a tensor made from host data would wait for
        # the device (a copy from pageable memory).
        dr = torch.full((), data_range, dtype=torch.float32, device=preds.device)
    c1 = (k1 * dr) ** 2
    c2 = (k2 * dr) ** 2

    x = preds.permute(0, 3, 1, 2)
    y = target.permute(0, 3, 1, 2)
    window = _gaussian_window(kernel_size, sigma, x.shape[1], x.device)
    mu_x = _depthwise_filter(x, window)
    mu_y = _depthwise_filter(y, window)
    mu_xx = _depthwise_filter(x * x, window)
    mu_yy = _depthwise_filter(y * y, window)
    mu_xy = _depthwise_filter(x * y, window)

    sigma_x = mu_xx - mu_x * mu_x
    sigma_y = mu_yy - mu_y * mu_y
    sigma_xy = mu_xy - mu_x * mu_y

    num = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    den = (mu_x * mu_x + mu_y * mu_y + c1) * (sigma_x + sigma_y + c2)
    return (num / den).reshape(num.shape[0], -1).mean(dim=-1)


def ssim(preds, target, data_range=None, mask=None, **kwargs) -> torch.Tensor:
    """Mean SSIM over an NHWC batch (a 0-d tensor)."""
    return masked_mean(ssim_per_image(preds, target, data_range, **kwargs), mask)


def psnr(preds, target, data_range: float = 1.0, mask=None) -> torch.Tensor:
    """Batch-global PSNR (a 0-d tensor)."""
    sq = torch.square(preds.to(torch.float32) - target.to(torch.float32))
    mse = masked_mean(sq.reshape(sq.shape[0], -1).mean(dim=-1), mask)
    return 10.0 * torch.log10((data_range**2) / mse)
