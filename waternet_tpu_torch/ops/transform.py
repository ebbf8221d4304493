"""The WaterNet preprocessing transform: rgb -> (wb, gc, he).

Keeps the reference wrapper's return order ``(wb, gc, he)`` while the
model consumes ``(x, wb, he, gc)``; callers reorder, as in the reference.

Host path: :func:`transform_np` (NumPy + cv2, bit-exact with the
reference). Device path: :func:`transform_batch`, the whole batch at once
on the tensor's device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from waternet_tpu_torch.ops.clahe import histeq, histeq_np
from waternet_tpu_torch.ops.gamma import gamma_correction, gamma_correction_np
from waternet_tpu_torch.ops.wb import white_balance, white_balance_np


def transform_np(rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host path. uint8 HWC RGB -> (wb, gc, he) uint8 HWC."""
    return white_balance_np(rgb), gamma_correction_np(rgb), histeq_np(rgb)


def transform_batch(rgb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N, H, W, 3) uint8 -> (wb, gc, he), float32 (N, H, W, 3) tensors
    holding exact uint8 values; divide by 255 to feed the network."""
    return white_balance(rgb), gamma_correction(rgb), histeq(rgb)
