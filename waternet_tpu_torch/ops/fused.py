"""The training step's preprocessing, in one place: paired augmentation,
the classical WB/GC/CLAHE views, and the [0, 1] scaling.

The same ops in the same order as the JAX package's
``ops/fused.py::fused_train_preprocess`` (augment, then
:func:`~waternet_tpu_torch.ops.transform.transform_batch`, then the five
``/255`` views), so the trainer feeds the network what the JAX trainer
feeds it. The CLAHE inside ``transform_batch`` launches the two CLAHE
kernels on CUDA.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from waternet_tpu_torch.data.augment import apply_augment_batch, augment_pair_batch
from waternet_tpu_torch.ops.transform import transform_batch


def fused_train_preprocess(
    raw_u8: torch.Tensor,
    ref_u8: torch.Tensor,
    generator: Optional[torch.Generator],
    augment: bool = True,
    draws: Optional[Tuple[torch.Tensor, ...]] = None,
) -> Tuple[torch.Tensor, ...]:
    """uint8 (raw, ref) batch -> ``(x, wbn, hen, gcn, refn)``, float32 in
    [0, 1], in the network's input order.

    ``generator`` draws the augmentation; with ``None`` (eval) nothing is
    augmented even when ``augment`` is True, as in the JAX trainer.
    ``draws`` (``(hflip, vflip, rotk)`` of :func:`~waternet_tpu_torch.data.
    augment.draw_augment`, one row per image) applies given draws instead:
    a data-parallel rank draws for the global batch and applies its rows."""
    raw = raw_u8.to(torch.float32)
    ref = ref_u8.to(torch.float32)
    if draws is not None:
        raw, ref = (apply_augment_batch(t, *draws) for t in (raw, ref))
    elif augment and generator is not None:
        raw, ref = augment_pair_batch(generator, raw, ref)
    wb, gc, he = transform_batch(raw)
    return raw / 255.0, wb / 255.0, he / 255.0, gc / 255.0, ref / 255.0
