"""Gamma correction: ``uint8(clip((im/255) ** 0.7 * 255, 0, 255))``.

The input domain is uint8, so the device path is an exact 256-entry lookup
table built in float64 on the host, bit-identical to the reference's
truncating formula (waternet_tpu/ops/gamma.py:20-35).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

GAMMA = 0.7


def _lut(gamma: float) -> np.ndarray:
    levels = np.arange(256, dtype=np.float64)
    out = np.clip(255.0 * np.power(levels / 255.0, gamma), 0, 255)
    return out.astype(np.uint8).astype(np.float32)  # truncation, as reference


def gamma_correction_np(img: np.ndarray, gamma: float = GAMMA) -> np.ndarray:
    """Host path. uint8 -> uint8, any shape."""
    out = np.power(img / 255.0, gamma)
    return np.clip(255.0 * out, 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _device_lut(gamma: float, device: torch.device) -> torch.Tensor:
    # jaxlint: disable-next=R003 first-call table (lru_cache per device): a blocking copy, safe on every stream
    return torch.from_numpy(_lut(gamma)).to(device)


def gamma_correction(img: torch.Tensor, gamma: float = GAMMA) -> torch.Tensor:
    """Device path. uint8-valued tensor -> float32 exact uint8 values."""
    return _device_lut(gamma, img.device)[img.long()]
