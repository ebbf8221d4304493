"""R002 suppressed: a global draw argued for in place."""

import torch


def demo_noise(shape):
    return torch.randn(shape)  # jaxlint: disable=R002 demo only: never on a reproducible path
