"""No-reference underwater image quality metrics: UCIQE and UIQM.

The port of the JAX package's ``training/metrics_nr.py``, on the port's
uint8 LAB (:func:`~waternet_tpu_torch.ops.color.rgb_to_lab_u8`). Same
formulations:

* **UCIQE** (Yang & Sowmya, 2015):
  ``0.4680 * sigma_c + 0.2745 * con_l + 0.2576 * mu_s`` (chroma std,
  luminance contrast between the 1% and 99% quantiles, saturation mean;
  8-bit LAB scaled by 1/255);
* **UIQM** (Panetta et al., 2016):
  ``0.0282 * UICM + 0.2953 * UISM + 3.5753 * UIConM`` (alpha-trimmed
  opponent-channel colourfulness, Sobel-EME sharpness over 8x8 blocks,
  Michelson-entropy contrast over 8x8 blocks, no PLIP operators).

Each metric takes one (H, W, 3) image at its own resolution;
``torch.quantile`` refuses inputs over 2**24 elements, so an image is
scored alone, never flattened with others.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from waternet_tpu_torch.ops.color import rgb_to_lab_u8

_SOBEL_X = ((1.0, 0.0, -1.0), (2.0, 0.0, -2.0), (1.0, 0.0, -1.0))


def _block_reduce(x: torch.Tensor, block: int, fn) -> torch.Tensor:
    """``fn`` (``torch.amax``/``torch.amin``) over non-overlapping
    (block, block) windows of a 2-D tensor; the remainder is cropped."""
    h, w = x.shape
    bh, bw = h // block, w // block
    v = x[: bh * block, : bw * block].reshape(bh, block, bw, block)
    return fn(fn(v, 3), 1)


def uciqe(rgb: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) uint8-valued RGB -> 0-d UCIQE."""
    lab = rgb_to_lab_u8(rgb)
    lum = lab[..., 0] / 255.0
    a = lab[..., 1] - 128.0
    b = lab[..., 2] - 128.0
    chroma = torch.sqrt(a * a + b * b) / 255.0
    sigma_c = torch.std(chroma, correction=0)
    q = torch.quantile(lum.reshape(-1), torch.tensor([0.99, 0.01], device=lum.device))
    con_l = q[0] - q[1]

    x = rgb.to(torch.float32) / 255.0
    mx = x.amax(dim=-1)
    mn = x.amin(dim=-1)
    sat = torch.where(mx > 0, (mx - mn) / torch.clamp(mx, min=1e-6), torch.zeros_like(mx))
    mu_s = torch.mean(sat)
    return 0.4680 * sigma_c + 0.2745 * con_l + 0.2576 * mu_s


def _alpha_trimmed_stats(v: torch.Tensor, alpha_l: float = 0.1, alpha_r: float = 0.1):
    s = torch.sort(v.reshape(-1)).values
    n = s.shape[0]
    t = s[int(n * alpha_l) : n - int(n * alpha_r)]
    mu = torch.mean(t)
    return mu, torch.mean(torch.square(t - mu))


def _uicm(rgb: torch.Tensor) -> torch.Tensor:
    x = rgb.to(torch.float32)
    rg = x[..., 0] - x[..., 1]
    yb = 0.5 * (x[..., 0] + x[..., 1]) - x[..., 2]
    mu_rg, var_rg = _alpha_trimmed_stats(rg)
    mu_yb, var_yb = _alpha_trimmed_stats(yb)
    return -0.0268 * torch.sqrt(mu_rg**2 + mu_yb**2) + 0.1586 * torch.sqrt(var_rg + var_yb)


def _sobel_mag(chan: torch.Tensor) -> torch.Tensor:
    kx = torch.tensor(_SOBEL_X, dtype=torch.float32, device=chan.device)
    weight = torch.stack([kx, kx.T])[:, None]
    pad = F.pad(chan[None, None], (1, 1, 1, 1), mode="replicate")
    g = F.conv2d(pad, weight)[0]
    return torch.sqrt(g[0] ** 2 + g[1] ** 2)


def _eme(chan: torch.Tensor, block: int = 8) -> torch.Tensor:
    mx = _block_reduce(chan, block, torch.amax)
    mn = _block_reduce(chan, block, torch.amin)
    ratio = torch.clamp(mx, min=1.0) / torch.clamp(mn, min=1.0)
    return torch.mean(2.0 * torch.log(ratio))


def _uism(rgb: torch.Tensor) -> torch.Tensor:
    x = rgb.to(torch.float32)
    total = 0.0
    for c, w in enumerate((0.299, 0.587, 0.114)):
        edge = _sobel_mag(x[..., c]) * x[..., c]
        total = total + w * _eme(edge)
    return total


def _uiconm(rgb: torch.Tensor, block: int = 8) -> torch.Tensor:
    inten = torch.mean(rgb.to(torch.float32), dim=-1)
    mx = _block_reduce(inten, block, torch.amax)
    mn = _block_reduce(inten, block, torch.amin)
    num = mx - mn
    den = torch.clamp(mx + mn, min=1e-6)
    r = torch.where(num > 0, num / den, torch.zeros_like(num))
    ent = torch.where(r > 0, r * torch.log(torch.clamp(r, min=1e-6)), torch.zeros_like(r))
    return torch.mean(ent) * -1.0


def uiqm(rgb: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) uint8-valued RGB -> 0-d UIQM."""
    return 0.0282 * _uicm(rgb) + 0.2953 * _uism(rgb) + 3.5753 * _uiconm(rgb)


def uciqe_batch(rgb: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) -> (N,) UCIQE, one image per call."""
    return torch.stack([uciqe(im) for im in rgb])


def uiqm_batch(rgb: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) -> (N,) UIQM, one image per call."""
    return torch.stack([uiqm(im) for im in rgb])
