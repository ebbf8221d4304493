"""Restormer's forward in plain float32 ``torch``, from its published
equations: the benchmark's frozen copy of ``waternet_tpu_torch/models/
restormer_plain.py``, the reference that decides ``correct`` in the
Restormer cells.

Zamir et al., *Restormer: Efficient Transformer for High-Resolution Image
Restoration*, CVPR 2022, arXiv:2111.09881; the official code's
``basicsr/models/archs/restormer_arch.py`` (github.com/swz30/Restormer).
Weights are a flat dict in the official state_dict's layout
(``encoder_level1.0.attn.qkv.weight``, ...); images are NCHW float
batches. ``cfg`` holds ``dim``, ``num_blocks``, ``num_refinement_blocks``,
``heads`` and ``ffn_expansion_factor``. Nothing of the program under test
is imported.

Every convolution and both attention products go through ``conv(x, w,
b=None, padding=0, groups=1)``, so a control can round their operands to
a lower precision. The products are written as the 1x1 convolutions they
are: ``A v`` convolves v with the ``c_h x c_h`` map as its weight, and the
Gram map ``q_hat k_hat^T`` convolves the ``(H*W, c_h)`` k_hat, whose
pixels are its channels, with q_hat as the weight.

Departures from the official code, none of which changes the
mathematics: the LayerNorm is written over NCHW's channel dimension (the
official code moves channels last and back); heads and frames run one at
a time; frames whose sides are not multiples of 8 are reflect-padded and
cropped back here, where the official code does it in its test scripts.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

LN_EPS = 1e-5
FACTOR = 8


def conv2d(x, w, b=None, padding=0, groups=1):
    """The reference convolution: float32 (the caller turns TF32 off)."""
    return F.conv2d(x, w, b, padding=padding, groups=groups)


def layer_norm(x, w, b):
    """WithBias LayerNorm over the channels of each pixel of NCHW ``x``."""
    mu = x.mean(1, keepdim=True)
    var = x.var(1, keepdim=True, unbiased=False)
    return (x - mu) / torch.sqrt(var + LN_EPS) * w.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)


def mdta(p, pre, x, heads, conv=conv2d):
    """Multi-Dconv head transposed attention of block ``pre``."""
    n, c, h, w = x.shape
    qkv = conv(conv(x, p[f"{pre}.qkv.weight"]), p[f"{pre}.qkv_dwconv.weight"], padding=1, groups=3 * c)
    q, k, v = qkv.chunk(3, dim=1)
    ch = c // heads
    frames = []
    for i in range(n):
        outs = []
        for hd in range(heads):
            rows = slice(hd * ch, (hd + 1) * ch)
            q_hat = F.normalize(q[i, rows].reshape(ch, h * w), dim=-1)
            k_hat = F.normalize(k[i, rows].reshape(ch, h * w), dim=-1)
            gram = conv(k_hat.t().reshape(1, h * w, ch, 1), q_hat.reshape(ch, h * w, 1, 1)).reshape(ch, ch)
            attn = torch.softmax(gram * p[f"{pre}.temperature"][hd], dim=-1)
            outs.append(conv(v[i:i + 1, rows], attn.reshape(ch, ch, 1, 1)))
        frames.append(torch.cat(outs, dim=1))
    return conv(torch.cat(frames), p[f"{pre}.project_out.weight"])


def gdfn(p, pre, x, factor, conv=conv2d):
    """Gated-Dconv feed-forward network of block ``pre``."""
    hidden = int(x.shape[1] * factor)
    y = conv(conv(x, p[f"{pre}.project_in.weight"]), p[f"{pre}.dwconv.weight"], padding=1, groups=2 * hidden)
    x1, x2 = y.chunk(2, dim=1)
    return conv(F.gelu(x1) * x2, p[f"{pre}.project_out.weight"])


def blocks(p, name, n, x, heads, factor, conv=conv2d):
    for i in range(n):
        pre = f"{name}.{i}"
        x = x + mdta(p, f"{pre}.attn", layer_norm(x, p[f"{pre}.norm1.body.weight"], p[f"{pre}.norm1.body.bias"]),
                     heads, conv)
        x = x + gdfn(p, f"{pre}.ffn", layer_norm(x, p[f"{pre}.norm2.body.weight"], p[f"{pre}.norm2.body.bias"]),
                     factor, conv)
    return x


def restormer(p, cfg, img, conv=conv2d):
    """Restormer on an NCHW [0, 1] batch -> NCHW float32: the input plus the
    output conv's residual, not clipped."""
    nb, heads, f = cfg["num_blocks"], cfg["heads"], cfg["ffn_expansion_factor"]
    h, w = img.shape[-2:]
    x = F.pad(img, (0, -w % FACTOR, 0, -h % FACTOR), mode="reflect") if (h % FACTOR or w % FACTOR) else img

    def down(name, t):
        return F.pixel_unshuffle(conv(t, p[f"{name}.body.0.weight"], padding=1), 2)

    def up(name, t):
        return F.pixel_shuffle(conv(t, p[f"{name}.body.0.weight"], padding=1), 2)

    enc1 = blocks(p, "encoder_level1", nb[0], conv(x, p["patch_embed.proj.weight"], padding=1), heads[0], f, conv)
    enc2 = blocks(p, "encoder_level2", nb[1], down("down1_2", enc1), heads[1], f, conv)
    enc3 = blocks(p, "encoder_level3", nb[2], down("down2_3", enc2), heads[2], f, conv)
    latent = blocks(p, "latent", nb[3], down("down3_4", enc3), heads[3], f, conv)
    dec3 = conv(torch.cat([up("up4_3", latent), enc3], 1), p["reduce_chan_level3.weight"])
    dec3 = blocks(p, "decoder_level3", nb[2], dec3, heads[2], f, conv)
    dec2 = conv(torch.cat([up("up3_2", dec3), enc2], 1), p["reduce_chan_level2.weight"])
    dec2 = blocks(p, "decoder_level2", nb[1], dec2, heads[1], f, conv)
    dec1 = blocks(p, "decoder_level1", nb[0], torch.cat([up("up2_1", dec2), enc1], 1), heads[0], f, conv)
    dec1 = blocks(p, "refinement", cfg["num_refinement_blocks"], dec1, heads[0], f, conv)
    out = conv(dec1, p["output.weight"], padding=1) + x
    return out[..., :h, :w]
