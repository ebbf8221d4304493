"""Training losses, as the reference and the JAX package define them.

* pixel MSE on the 0-255 scale: ``mean(square(255 * (out - ref)))``;
* perceptual: ``mean(square(255 * (vgg(norm(out)) - vgg(norm(ref)))))``,
  ``norm`` the ImageNet normalization and ``vgg`` VGG19 through relu5_4;
* the composite ``PERCEPTUAL_WEIGHT * perceptual + mse`` lives in the
  trainer.

Each term takes an optional (N,) ``mask`` of the real images in a batch.
"""

from __future__ import annotations

import torch

from waternet_tpu_torch.models.vgg import VGG19Features, imagenet_normalize
from waternet_tpu_torch.training.metrics import masked_mean

PERCEPTUAL_WEIGHT = 0.05  # the reference's train.py:127


def _per_image_mean(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).mean(dim=-1)


def mse_255(out: torch.Tensor, ref: torch.Tensor, mask=None) -> torch.Tensor:
    return masked_mean(_per_image_mean(torch.square(255.0 * (out - ref))), mask)


def perceptual_loss(
    vgg: VGG19Features,
    out: torch.Tensor,
    ref: torch.Tensor,
    mask=None,
    ref_feats: torch.Tensor | None = None,
) -> torch.Tensor:
    """``ref_feats``, when given, stands in for ``vgg(norm(ref))`` (and
    ``ref`` is ignored). The ref branch carries no gradient either way."""
    fx = vgg(imagenet_normalize(out))
    if ref_feats is None:
        with torch.no_grad():
            ref_feats = vgg(imagenet_normalize(ref))
    return masked_mean(_per_image_mean(torch.square(255.0 * (fx - ref_feats))), mask)
