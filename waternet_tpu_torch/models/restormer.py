"""Restormer: transposed channel attention and a gated depthwise FFN in a
four-level U-Net, raw RGB in, restored RGB out.

After *Restormer: Efficient Transformer for High-Resolution Image
Restoration* (Zamir et al., CVPR 2022, arXiv:2111.09881) and its official
code (github.com/swz30/Restormer, ``basicsr/models/archs/
restormer_arch.py``), at the published configuration of
``Motion_Deblurring/Options/Deblurring_Restormer.yml``: ``dim`` 48,
``num_blocks`` (4, 6, 6, 8), 4 refinement blocks, ``heads`` (1, 2, 4, 8),
``ffn_expansion_factor`` 2.66, no conv bias, the WithBias LayerNorm;
26,126,644 parameters. Module and parameter names are the official
state_dict's, so its checkpoints (bare, or wrapped under ``params`` as
basicsr saves them) load strictly.

Each block is ``x += MDTA(LN1(x))`` then ``x += GDFN(LN2(x))``:

* LN: over each pixel's channels, ``(x - mean) / sqrt(var + 1e-5) * w + b``
  (biased variance);
* MDTA: ``qkv = DW3x3(Conv1x1(x, C -> 3C))``; per head, q and k viewed as
  ``(c_h, H*W)`` are L2-normalised over ``H*W``, ``A = softmax(q k^T *
  temperature)`` is a ``c_h x c_h`` map, and ``Conv1x1(A v, C -> C)`` the
  output;
* GDFN: ``[x1, x2] = DW3x3(Conv1x1(x, C -> 2h))``, ``h = int(2.66 C)``,
  then ``Conv1x1(GELU(x1) * x2, h -> C)``.

How the port computes them (``models/restormer_plain.py`` is the equations
as written, in float32):

* The residual stream is NHWC, the port's public layout: the full 3x3
  convolutions see it as a channels-last NCHW view, the LayerNorm is
  ``F.layer_norm`` over its last dimension, and PixelShuffle/
  PixelUnshuffle and the skips' concatenations are NHWC reshapes. Each
  branch's 1x1 project-in is one batched product per call that writes
  NCHW (``W @ x^T``), so its depthwise conv runs on a contiguous NCHW
  tensor and the gate and the attention's products read whole channel
  rows; the branch's last product (``x^T @ W^T``) writes NHWC again. No
  transpose is a pass of its own. (cuDNN's channels-last kernel for
  these depthwise widths, none a multiple of 8, ran more than ten times
  slower on an H100.)
* The depthwise convs run, on CUDA with grad off and nothing tracing
  (``ops/kernels.py::kernel_route``: the engines' inference), in one
  hand-written kernel, ``ops/kernels.py::dwconv3x3``: MDTA's as it is,
  GDFN's with its gate in the kernel's epilogue, so the 2h planes are
  read once and only ``GELU(x1) * x2``'s h are written, to the eager
  gate's bytes. 44 launches of each a forward at the published depth.
  Elsewhere (the CPU, training under grad, ``torch.export``) they are
  ``ops/kernels.py::dwconv3x3_plain``: ``F.conv2d`` with the modules'
  weights, then ``chunk`` and ``F.gelu(x1) * x2``.
* The attention never normalises q and k. The Gram products ``q k^T``
  run on the raw q and k (per frame, all heads in one batched product),
  then are divided by the float32 L2 norms of their rows:
  ``q_hat k_hat^T = (q k^T) / (|q| |k|^T)``. ``A v`` and the output
  projection are one product: ``Conv1x1(A v) = (W blockdiag(A)) v``, a
  ``C x C`` matrix per frame made in float32, applied to v in one
  batched product. Both are exact in real arithmetic.
* ``dtype=torch.bfloat16`` runs under autocast over float32 parameters,
  as ``CANStudent`` does. The LayerNorm runs outside autocast on the bf16
  stream, its affine in bf16 and its mean and variance in float32 (the
  kernels' accumulation type); the L2 norms, the softmax and the mixing
  matrix run in float32. The output conv's result is added to the input
  in float32.
* Height and width that are not multiples of 8 (three 2x downsamplings)
  are reflect-padded bottom and right and cropped back, as the official
  test scripts do. The transposed attention is global: every output pixel
  depends on the whole frame through the Gram maps, so the pad (and any
  tiling) changes the result; whole frames are the unit of work.

With the trace recorder armed, each block records two spans of cat
``model`` through ``obs/stages.py``: ``model.mdta`` (LN1, attention and
residual) and ``model.gdfn`` (LN2, FFN and residual), each with
``frames``, ``level`` (1 at full resolution to 4 at an eighth) and, on
CUDA, ``device_ms`` between two timing events. Disarmed they make no
event and read no clock. :data:`BLOCK_RUNS` counts the blocks' two halves
whether armed or not: 44 of each per forward at the published depth.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from waternet_tpu_torch.obs.stages import stage_clock
from waternet_tpu_torch.ops.kernels import dwconv3x3, dwconv3x3_plain, kernel_route

#: The published configuration (Deblurring_Restormer.yml).
DIM = 48
NUM_BLOCKS = (4, 6, 6, 8)
NUM_REFINEMENT_BLOCKS = 4
HEADS = (1, 2, 4, 8)
FFN_EXPANSION_FACTOR = 2.66
#: Frames are padded to a multiple of this: three 2x downsamplings.
FACTOR = 8
LN_EPS = 1e-5
#: ``torch.nn.functional.normalize``'s floor on a norm.
NORM_EPS = 1e-12
#: Span category of the blocks' spans.
CAT = "model"

#: Block halves run since the last :func:`reset_block_runs`.
BLOCK_RUNS = {"mdta": 0, "gdfn": 0}


def reset_block_runs() -> None:
    for name in BLOCK_RUNS:
        BLOCK_RUNS[name] = 0


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` on an NHWC tensor, through its channels-last NCHW view."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _project_in(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 ``conv`` from NHWC ``x`` to a contiguous NCHW result: per frame
    ``W @ x^T``, one batched product over the weight broadcast."""
    b, h, w, c = x.shape
    weight = conv.weight.flatten(1)
    out = torch.bmm(weight.expand(b, -1, -1), x.reshape(b, h * w, c).transpose(1, 2))
    return out.view(b, -1, h, w)


def _project_out(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 ``conv`` from NCHW ``x`` to a contiguous NHWC result: per frame
    ``x^T @ W^T``."""
    b, c, h, w = x.shape
    weight = conv.weight.flatten(1).t()
    return torch.bmm(x.reshape(b, c, h * w).transpose(1, 2), weight.expand(b, -1, -1)).view(b, h, w, -1)


def _dwconv(conv: nn.Conv2d, x: torch.Tensor, gate: bool) -> torch.Tensor:
    """The depthwise 3x3 ``conv`` of NCHW ``x``, and for ``gate`` GELU of
    its first channel half times its second: one :func:`dwconv3x3` launch
    where ``kernel_route(x)``, else its plain PyTorch ops. The kernel takes
    the float32 weight and rounds it as autocast would."""
    if kernel_route(x):
        return dwconv3x3(x, conv.weight, gate)
    return dwconv3x3_plain(x, conv.weight, gate)


def _pixel_unshuffle(x: torch.Tensor) -> torch.Tensor:
    """``nn.PixelUnshuffle(2)`` in NHWC: out channel ``c*4 + i*2 + j`` is
    input channel ``c`` at row offset ``i`` and column offset ``j``."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4).reshape(b, h // 2, w // 2, 4 * c)


def _pixel_shuffle(x: torch.Tensor) -> torch.Tensor:
    """``nn.PixelShuffle(2)`` in NHWC, the inverse of :func:`_pixel_unshuffle`."""
    b, h, w, c = x.shape
    return x.reshape(b, h, w, c // 4, 2, 2).permute(0, 1, 4, 2, 5, 3).reshape(b, 2 * h, 2 * w, c // 4)


class WithBiasLayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


class LayerNorm(nn.Module):
    """The channel LayerNorm of an NHWC tensor (official ``LayerNorm`` with
    ``LayerNorm_type='WithBias'``, whose parameters sit under ``body``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.body = WithBiasLayerNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.autocast(x.device.type, enabled=False):
            return F.layer_norm(x, x.shape[-1:], self.body.weight.to(x.dtype), self.body.bias.to(x.dtype), LN_EPS)


class Attention(nn.Module):
    """MDTA, the multi-Dconv head transposed attention."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = nn.Conv2d(dim, dim * 3, kernel_size=1, bias=False)
        self.qkv_dwconv = nn.Conv2d(dim * 3, dim * 3, kernel_size=3, padding=1, groups=dim * 3, bias=False)
        self.project_out = nn.Conv2d(dim, dim, kernel_size=1, bias=False)

    def _mixing(self, q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        """(B, C, C) float32: the output projection times the block-diagonal
        attention maps of each frame. ``q``, ``k``: (B, C, H*W)."""
        b, c, _ = q.shape
        heads = self.num_heads
        ch = c // heads
        gram = torch.stack([torch.bmm(qi.view(heads, ch, -1), ki.view(heads, ch, -1).transpose(1, 2))
                            for qi, ki in zip(q, k)]).float()
        nq = torch.linalg.vector_norm(q, dim=-1, dtype=torch.float32).clamp_min(NORM_EPS).view(b, heads, ch, 1)
        nk = torch.linalg.vector_norm(k, dim=-1, dtype=torch.float32).clamp_min(NORM_EPS).view(b, heads, 1, ch)
        attn = torch.softmax(gram / (nq * nk) * self.temperature, dim=-1)
        proj = self.project_out.weight.view(c, heads, ch).float()
        return torch.einsum("ohi,bhij->bohj", proj, attn).reshape(b, c, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        qkv = _dwconv(self.qkv_dwconv, _project_in(self.qkv, x), gate=False).flatten(2)
        q, k, v = qkv.split(c, dim=1)
        with torch.autocast(x.device.type, enabled=False):
            mixing = self._mixing(q, k)
            out = torch.bmm(v.transpose(1, 2), mixing.transpose(1, 2).to(v.dtype))
        return out.view(b, h, w, c)


class FeedForward(nn.Module):
    """GDFN, the gated depthwise feed-forward network."""

    def __init__(self, dim: int, ffn_expansion_factor: float):
        super().__init__()
        hidden = int(dim * ffn_expansion_factor)
        self.project_in = nn.Conv2d(dim, hidden * 2, kernel_size=1, bias=False)
        self.dwconv = nn.Conv2d(hidden * 2, hidden * 2, kernel_size=3, padding=1, groups=hidden * 2, bias=False)
        self.project_out = nn.Conv2d(hidden, dim, kernel_size=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _project_out(self.project_out, _dwconv(self.dwconv, _project_in(self.project_in, x), gate=True))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, ffn_expansion_factor: float, level: int):
        super().__init__()
        self.level = level
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads)
        self.norm2 = LayerNorm(dim)
        self.ffn = FeedForward(dim, ffn_expansion_factor)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        clock, dev, frames = stage_clock(CAT), x.device, x.shape[0]
        clock.begin(dev)
        x = x + self.attn(self.norm1(x))
        clock.end("model.mdta", dev, frames=frames, level=self.level)
        BLOCK_RUNS["mdta"] += 1
        clock.begin(dev)
        x = x + self.ffn(self.norm2(x))
        clock.end("model.gdfn", dev, frames=frames, level=self.level)
        BLOCK_RUNS["gdfn"] += 1
        return x


class Resample(nn.Module):
    """The official ``Downsample``/``Upsample``: a bias-free 3x3 conv under
    ``body.0``, then PixelUnshuffle(2) or PixelShuffle(2) (applied by the
    caller, in NHWC)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.body = nn.Sequential(nn.Conv2d(cin, cout, kernel_size=3, padding=1, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv(self.body[0], x)


def _blocks(n: int, dim: int, heads: int, factor: float, level: int) -> nn.Sequential:
    return nn.Sequential(*[TransformerBlock(dim, heads, factor, level) for _ in range(n)])


class Restormer(nn.Module):
    """``model(x)``: an (N, H, W, 3) float tensor in [0, 1] -> (N, H, W, 3)
    float32, the input plus the restored residual (not clipped)."""

    def __init__(
        self,
        dim: int = DIM,
        num_blocks: Sequence[int] = NUM_BLOCKS,
        num_refinement_blocks: int = NUM_REFINEMENT_BLOCKS,
        heads: Sequence[int] = HEADS,
        ffn_expansion_factor: float = FFN_EXPANSION_FACTOR,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {dtype}")
        self.dtype = dtype
        d, f = dim, ffn_expansion_factor
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, d, kernel_size=3, padding=1, bias=False)
        self.encoder_level1 = _blocks(num_blocks[0], d, heads[0], f, 1)
        self.down1_2 = Resample(d, d // 2)
        self.encoder_level2 = _blocks(num_blocks[1], d * 2, heads[1], f, 2)
        self.down2_3 = Resample(d * 2, d)
        self.encoder_level3 = _blocks(num_blocks[2], d * 4, heads[2], f, 3)
        self.down3_4 = Resample(d * 4, d * 2)
        self.latent = _blocks(num_blocks[3], d * 8, heads[3], f, 4)
        self.up4_3 = Resample(d * 8, d * 16)
        self.reduce_chan_level3 = nn.Conv2d(d * 8, d * 4, kernel_size=1, bias=False)
        self.decoder_level3 = _blocks(num_blocks[2], d * 4, heads[2], f, 3)
        self.up3_2 = Resample(d * 4, d * 8)
        self.reduce_chan_level2 = nn.Conv2d(d * 4, d * 2, kernel_size=1, bias=False)
        self.decoder_level2 = _blocks(num_blocks[1], d * 2, heads[1], f, 2)
        self.up2_1 = Resample(d * 2, d * 4)
        self.decoder_level1 = _blocks(num_blocks[0], d * 2, heads[0], f, 1)
        self.refinement = _blocks(num_refinement_blocks, d * 2, heads[0], f, 1)
        self.output = nn.Conv2d(d * 2, 3, kernel_size=3, padding=1, bias=False)

    def _delta(self, x: torch.Tensor) -> torch.Tensor:
        """The restored residual of an NHWC batch whose sides are multiples
        of :data:`FACTOR`."""
        enc1 = self.encoder_level1(_conv(self.patch_embed.proj, x))
        enc2 = self.encoder_level2(_pixel_unshuffle(self.down1_2(enc1)))
        enc3 = self.encoder_level3(_pixel_unshuffle(self.down2_3(enc2)))
        latent = self.latent(_pixel_unshuffle(self.down3_4(enc3)))
        dec3 = torch.cat([_pixel_shuffle(self.up4_3(latent)), enc3], dim=-1)
        dec3 = self.decoder_level3(_conv(self.reduce_chan_level3, dec3))
        dec2 = torch.cat([_pixel_shuffle(self.up3_2(dec3)), enc2], dim=-1)
        dec2 = self.decoder_level2(_conv(self.reduce_chan_level2, dec2))
        dec1 = torch.cat([_pixel_shuffle(self.up2_1(dec2)), enc1], dim=-1)
        return _conv(self.output, self.refinement(self.decoder_level1(dec1)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1:3]
        pad_h, pad_w = -h % FACTOR, -w % FACTOR
        if pad_h or pad_w:
            x = F.pad(x.permute(0, 3, 1, 2), (0, pad_w, 0, pad_h), mode="reflect").permute(0, 2, 3, 1).contiguous()
        if self.dtype == torch.float32:
            delta = self._delta(x)
        else:
            with torch.autocast(x.device.type, dtype=self.dtype):
                delta = self._delta(x)
        return (x.to(torch.float32) + delta.to(torch.float32))[:, :h, :w]


# ----------------------------------------------------------------------
# Weights: the official layout, the configuration they imply.
# ----------------------------------------------------------------------


def restormer_state_dict(params) -> dict:
    """A state_dict in the official layout, bare or wrapped under
    ``params`` (basicsr's checkpoints), as a flat dict of tensors."""
    if not isinstance(params, dict) or not params:
        raise ValueError("Restormer weights are not a state_dict (empty or not a dict)")
    if set(params) == {"params"}:
        params = params["params"]
    return {k: torch.as_tensor(v) for k, v in params.items()}


def restormer_config_from_params(sd: dict) -> dict:
    """``dim``, ``num_blocks``, ``num_refinement_blocks`` and ``heads`` of
    an official-layout state_dict (the FFN factor is the published 2.66,
    the only one the official configurations use), checked against
    :class:`Restormer` through the same mismatch report the CAN student's
    loader uses. Raises ValueError naming what does not fit."""
    from waternet_tpu_torch.utils.checkpoint import params_mismatch_report

    def count(prefix):
        return len({k.split(".")[1] for k in sd if k.startswith(prefix + ".")})

    try:
        levels = ("encoder_level1", "encoder_level2", "encoder_level3", "latent")
        cfg = {
            "dim": int(sd["patch_embed.proj.weight"].shape[0]),
            "num_blocks": tuple(count(name) for name in levels),
            "num_refinement_blocks": count("refinement"),
            "heads": tuple(int(sd[f"{name}.0.attn.temperature"].shape[0]) for name in levels),
        }
    except (KeyError, AttributeError, IndexError) as err:
        raise ValueError(f"not a Restormer state_dict in the official layout: missing {err}") from None
    with torch.device("meta"):
        shapes = Restormer(**cfg).state_dict()
    report = params_mismatch_report(sd, shapes)
    if report:
        raise ValueError(f"weights do not fit Restormer({cfg}):\n{report}")
    return cfg


def build_restormer(params, device, dtype: torch.dtype = torch.float32) -> Restormer:
    """A :class:`Restormer` on ``device`` in eval mode with ``params`` (official layout, bare or under ``params``) loaded strictly;
    the configuration from the weights."""
    sd = restormer_state_dict(params)
    model = Restormer(**restormer_config_from_params(sd), dtype=dtype)
    model.load_state_dict(sd, strict=True)
    return model.to(device).eval()

