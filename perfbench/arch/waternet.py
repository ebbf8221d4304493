"""WaterNet: the quality engine of ``waternet_tpu_torch`` and its plain
reference."""

from __future__ import annotations

import numpy as np
import torch

from perfbench.arch.weights import conv_leaves, uniform_leaves
from perfbench.reference import nets, preprocess


def leaves(cfg: dict) -> list:
    out = []
    for i, (cin, cout, k) in enumerate(cfg["cmg"], start=1):
        out += conv_leaves(f"cmg.conv{i}", cin, cout, k)
    for name in cfg["refiners"]:
        for i, (cin, cout, k) in enumerate(cfg["refiner"], start=1):
            out += conv_leaves(f"{name}.conv{i}", cin, cout, k)
    return out


def vgg_leaves() -> list:
    out = []
    for idx, cin, cout in nets.vgg19_layers():
        out += conv_leaves(f"features.{idx}", cin, cout, 3)
    return out


def make_params(cfg: dict, gen: torch.Generator, device) -> dict:
    return uniform_leaves(leaves(cfg), gen, device)


def make_vgg(gen: torch.Generator, device) -> dict:
    return uniform_leaves(vgg_leaves(), gen, device)


def engine(cfg: dict, params: dict, device, quantize: bool = False):
    """The configuration's engine: device preprocessing, bf16 compute over
    float32 parameters (the int8 path with ``quantize``, the control)."""
    from waternet_tpu_torch.inference_engine import InferenceEngine

    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[cfg["precision"]]
    sd = {k: v.detach().cpu() for k, v in params.items()}
    return InferenceEngine(params=sd, device_preprocess=True, device=device, dtype=dtype, quantize=quantize)


@torch.no_grad()
def reference(cfg: dict, params: dict, img: torch.Tensor, canvas: torch.Tensor | None = None,
              conv=nets.conv2d) -> torch.Tensor:
    """The reference's uint8 output for one (H, W, 3) uint8 image on the
    device. With ``canvas`` (the image padded to a bucket), the classical
    inputs take their statistics from the image and cover the canvas, the
    forward runs on the canvas and the output is cropped back."""
    src = img if canvas is None else canvas
    wb, gc, he = preprocess.transforms(img, canvas)
    planes = [t.permute(2, 0, 1)[None] / 255.0 for t in (src.to(torch.float32), wb, he, gc)]
    out = nets.waternet(params, cfg, *planes, conv=conv)[0].permute(1, 2, 0)
    return preprocess.to_u8(out[: img.shape[0], : img.shape[1]])


def reference_padded(cfg: dict, params: dict, img: np.ndarray, bucket, device, conv=nets.conv2d):
    canvas = preprocess.pad_to_bucket(img, *bucket)
    return reference(cfg, params, torch.from_numpy(img).to(device), torch.from_numpy(canvas).to(device), conv)
