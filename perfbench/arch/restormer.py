"""Restormer: the ``RestormerEngine`` of ``waternet_tpu_torch`` and its
plain reference. Raw RGB in, whole frames (the attention is global).

Weights come from their own draw: every convolution uniform within
``1 / sqrt(fan_in)`` (PyTorch's default Conv2d bound, which the official
model keeps), LayerNorm weights ``1 + U(-0.1, 0.1)`` and biases
``U(-0.1, 0.1)``, temperatures ``1 + U(-0.1, 0.1)``, so a dropped or
swapped affine term shows. The ``output`` conv's weights are scaled by
the configuration's ``output_scale``.

The control, ``engine(..., quantize=True)``, puts the plain reference in
the program's place with every convolution's and both attention products'
operands rounded to float8 e4m3 (``compare.fp8_conv2d``'s rounding).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import compare, preprocess
from perfbench.reference import restormer as ref


def _levels(cfg: dict) -> list:
    """[(state_dict prefix, blocks, width, heads)] of the block groups, in
    the official state_dict's order."""
    d, nb, hd = cfg["dim"], cfg["num_blocks"], cfg["heads"]
    return [("encoder_level1", nb[0], d, hd[0]), ("encoder_level2", nb[1], 2 * d, hd[1]),
            ("encoder_level3", nb[2], 4 * d, hd[2]), ("latent", nb[3], 8 * d, hd[3]),
            ("decoder_level3", nb[2], 4 * d, hd[2]), ("decoder_level2", nb[1], 2 * d, hd[1]),
            ("decoder_level1", nb[0], 2 * d, hd[0]), ("refinement", cfg["num_refinement_blocks"], 2 * d, hd[0])]


def _conv(name: str, cin: int, cout: int, k: int, groups: int = 1) -> tuple:
    return (name, (cout, cin // groups, k, k), "conv", cin // groups * k * k)


def leaves(cfg: dict) -> list:
    """[(name, shape, kind, fan_in)] of every parameter, in the official
    layout; kind is conv, ln_weight, ln_bias or temperature."""
    d, f = cfg["dim"], cfg["ffn_expansion_factor"]
    resample = {"down1_2": (d, d // 2), "down2_3": (2 * d, d), "down3_4": (4 * d, 2 * d),
                "up4_3": (8 * d, 16 * d), "up3_2": (4 * d, 8 * d), "up2_1": (2 * d, 4 * d)}
    reduce = {"decoder_level3": ("reduce_chan_level3", 8 * d, 4 * d), "decoder_level2": ("reduce_chan_level2", 4 * d, 2 * d)}
    before = {"encoder_level2": "down1_2", "encoder_level3": "down2_3", "latent": "down3_4",
              "decoder_level3": "up4_3", "decoder_level2": "up3_2", "decoder_level1": "up2_1"}
    out = [_conv("patch_embed.proj.weight", 3, d, 3)]
    for name, n, c, heads in _levels(cfg):
        if name in before:
            out.append(_conv(f"{before[name]}.body.0.weight", *resample[before[name]], 3))
        if name in reduce:
            out.append(_conv(f"{reduce[name][0]}.weight", *reduce[name][1:], 1))
        hidden = int(c * f)
        for i in range(n):
            pre = f"{name}.{i}"
            for norm, mod in (("norm1", "attn"), ("norm2", "ffn")):
                out += [(f"{pre}.{norm}.body.weight", (c,), "ln_weight", 0),
                        (f"{pre}.{norm}.body.bias", (c,), "ln_bias", 0)]
                if mod == "attn":
                    out += [(f"{pre}.attn.temperature", (heads, 1, 1), "temperature", 0),
                            _conv(f"{pre}.attn.qkv.weight", c, 3 * c, 1),
                            _conv(f"{pre}.attn.qkv_dwconv.weight", 3 * c, 3 * c, 3, 3 * c),
                            _conv(f"{pre}.attn.project_out.weight", c, c, 1)]
                else:
                    out += [_conv(f"{pre}.ffn.project_in.weight", c, 2 * hidden, 1),
                            _conv(f"{pre}.ffn.dwconv.weight", 2 * hidden, 2 * hidden, 3, 2 * hidden),
                            _conv(f"{pre}.ffn.project_out.weight", hidden, c, 1)]
    return out + [_conv("output.weight", 2 * d, 3, 3)]


def make_params(cfg: dict, gen: torch.Generator, device) -> dict:
    """One uniform draw on ``device``, each leaf a slice of it: float32,
    the type the program serves them in."""
    spec = leaves(cfg)
    sizes = [math.prod(shape) for _, shape, _, _ in spec]
    flat = torch.rand(sum(sizes), generator=gen, device=device, dtype=torch.float32).mul_(2.0).sub_(1.0)
    out, start = {}, 0
    for (name, shape, kind, fan_in), size in zip(spec, sizes):
        u = flat[start:start + size].view(shape)
        start += size
        if kind == "conv":
            scale = cfg["output_scale"] if name == "output.weight" else 1.0
            out[name] = u.mul_(scale / math.sqrt(fan_in))
        elif kind == "ln_bias":
            out[name] = u.mul_(0.1)
        else:
            out[name] = u.mul_(0.1).add_(1.0)
    return out


def fp8_conv(x, w, b=None, padding=0, groups=1):
    """The control's convolution: operands rounded to float8 e4m3 under a
    per-tensor scale (``compare.fp8_conv2d``'s rounding), products summed
    in float32; ``groups`` for the depthwise convolutions."""
    return F.conv2d(compare._FakeFp8.apply(x), compare._FakeFp8.apply(w), b, padding=padding, groups=groups)


class Fp8Reference:
    """The control in the engine's place: ``enhance_async`` runs the plain
    reference frame by frame with :func:`fp8_conv`."""

    def __init__(self, cfg: dict, params: dict, device):
        self.cfg, self.params, self.device = cfg, params, torch.device(device)

    @torch.no_grad()
    def enhance_async(self, frames) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(frames)).to(self.device).permute(0, 3, 1, 2).float() / 255.0
        out = [ref.restormer(self.params, self.cfg, x[i:i + 1], conv=fp8_conv) for i in range(len(x))]
        return torch.cat(out).permute(0, 2, 3, 1)


def engine(cfg: dict, params: dict, device, quantize: bool = False):
    """The configuration's engine: bf16 compute over float32 parameters
    (the fp8 control with ``quantize``)."""
    if quantize:
        return Fp8Reference(cfg, params, device)
    from waternet_tpu_torch.inference_engine import RestormerEngine

    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[cfg["precision"]]
    sd = {k: v.detach().cpu() for k, v in params.items()}
    return RestormerEngine(params=sd, dtype=dtype, device=device)


@torch.no_grad()
def reference(cfg: dict, params: dict, img: torch.Tensor, conv=ref.conv2d) -> torch.Tensor:
    """The reference's uint8 output for one (H, W, 3) uint8 image on the
    device, the whole frame in one forward."""
    x = img.to(torch.float32).permute(2, 0, 1)[None] / 255.0
    return preprocess.to_u8(ref.restormer(params, cfg, x, conv)[0].permute(1, 2, 0))
