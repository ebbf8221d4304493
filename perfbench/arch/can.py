"""CAN: the fast tier's student engine of ``waternet_tpu_torch`` and its
plain reference. Raw RGB in, no classical transform."""

from __future__ import annotations

import numpy as np
import torch

from perfbench.arch.weights import conv_leaves, uniform_leaves
from perfbench.reference import nets, preprocess


def leaves(cfg: dict) -> list:
    out, cin = [], 3
    for i in range(cfg["depth"]):
        out += conv_leaves(f"layers.{i}", cin, cfg["width"], 3)
        cin = cfg["width"]
    return out + conv_leaves(f"layers.{cfg['depth']}", cin, 3, 1)


def make_params(cfg: dict, gen: torch.Generator, device) -> dict:
    return uniform_leaves(leaves(cfg), gen, device)


def engine(cfg: dict, params: dict, device, quantize: bool = False):
    from waternet_tpu_torch.inference_engine import StudentEngine

    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[cfg["precision"]]
    sd = {k: v.detach().cpu() for k, v in params.items()}
    return StudentEngine(params=sd, dtype=dtype, device=device, quantize=quantize)


@torch.no_grad()
def reference(cfg: dict, params: dict, img: torch.Tensor, canvas: torch.Tensor | None = None,
              conv=nets.conv2d) -> torch.Tensor:
    src = img if canvas is None else canvas
    x = src.to(torch.float32).permute(2, 0, 1)[None] / 255.0
    out = nets.can(params, cfg["width"], cfg["depth"], x, conv=conv)[0].permute(1, 2, 0)
    return preprocess.to_u8(out[: img.shape[0], : img.shape[1]])


def reference_padded(cfg: dict, params: dict, img: np.ndarray, bucket, device, conv=nets.conv2d):
    canvas = preprocess.pad_to_bucket(img, *bucket)
    return reference(cfg, params, torch.from_numpy(img).to(device), torch.from_numpy(canvas).to(device), conv)
