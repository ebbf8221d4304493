"""VGG19 features through relu5_4, for the perceptual loss.

torchvision's ``vgg19().features`` without its final maxpool (the
reference's ``features[:-1]`` cut), as an ``nn.Module`` whose keys are
torchvision's own, ``features.{idx}.{weight,bias}``: a torchvision
state_dict loads as is. NHWC [0, 1] images in (after
:func:`imagenet_normalize`), an (N, H/16, W/16, 512) float32 map out, the
layout of the JAX package's ``models/vgg.py``.

No VGG19 weights ship with the repository. Without them,
:func:`resolve_vgg_params` falls back to a deterministic random init and
warns: random conv features still define a usable perceptual distance,
but training is then not reference-parity.
"""

from __future__ import annotations

import functools
import os
import sys
from pathlib import Path

import numpy as np
import torch
from torch import nn

# Conv widths; "M" = 2x2/stride-2 maxpool (torchvision's vgg19 topology,
# the final "M" at features[36] dropped).
_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
        512, 512, 512, 512, "M", 512, 512, 512, 512)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def conv_indices() -> list[int]:
    """torchvision ``features`` indices of the 16 convs (each followed by
    its ReLU; maxpools take one index)."""
    idx, out = 0, []
    for v in _CFG:
        if v == "M":
            idx += 1
        else:
            out.append(idx)
            idx += 2
    return out


class VGG19Features(nn.Module):
    """NHWC image -> relu5_4 feature map (N, H/16, W/16, 512), float32."""

    def __init__(self):
        super().__init__()
        layers: list[nn.Module] = []
        cin = 3
        for v in _CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, v, 3, padding=1), nn.ReLU(inplace=True)]
                cin = v
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.features(x.permute(0, 3, 1, 2))
        return out.permute(0, 2, 3, 1).to(torch.float32)


@functools.lru_cache(maxsize=None)
def _imagenet_stats(device: torch.device):
    """(mean, std) on ``device``, copied once per device: a copy from host
    memory in the step would make the host wait for the device's work.
    Made outside inference mode, since autograd saves ``std``."""
    with torch.inference_mode(False):
        return (
            # jaxlint: disable-next=R003 first-call table (lru_cache per device): a blocking copy, safe on every stream
            torch.from_numpy(IMAGENET_MEAN).to(device),
            # jaxlint: disable-next=R003 first-call table (lru_cache per device): a blocking copy, safe on every stream
            torch.from_numpy(IMAGENET_STD).to(device),
        )


def imagenet_normalize(x: torch.Tensor) -> torch.Tensor:
    """Per-channel ImageNet normalization of [0, 1] NHWC images."""
    mean, std = _imagenet_stats(x.device)
    return (x - mean) / std


def init_vgg_params(seed: int = 42) -> dict[str, torch.Tensor]:
    """Deterministic random init (the no-weights fallback): LeCun-normal
    kernels truncated at two standard deviations and zero biases, the
    scheme of Flax's default conv init, drawn from a seeded
    ``torch.Generator``. The values differ from the JAX package's init."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for idx, mod in zip(conv_indices(), (m for m in VGG19Features().features if isinstance(m, nn.Conv2d))):
        cout, cin, kh, kw = mod.weight.shape
        std = (1.0 / (cin * kh * kw)) ** 0.5 / 0.87962566103423978
        w = torch.empty((cout, cin, kh, kw))
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
        sd[f"features.{idx}.weight"] = w
        sd[f"features.{idx}.bias"] = torch.zeros(cout)
    return sd


def features_state_dict(sd: dict) -> dict[str, torch.Tensor]:
    """The conv weights of a torchvision VGG19 state_dict (full model or
    ``features`` only; the reference's ``model.{idx}`` prefix too) as the
    keys :class:`VGG19Features` takes."""
    keep = set(conv_indices())
    out = {}
    for key, val in sd.items():
        parts = key.split(".")
        if len(parts) == 3 and parts[0] in ("features", "model") and parts[2] in ("weight", "bias"):
            if int(parts[1]) in keep:
                out[f"features.{parts[1]}.{parts[2]}"] = torch.as_tensor(val).to(torch.float32)
    if not out:
        raise ValueError("no VGG19 conv layers found in the state_dict")
    return out


def resolve_vgg_params(path=None, verbose: bool = True) -> dict[str, torch.Tensor]:
    """VGG19 weights for the perceptual loss, as a state_dict.

    Resolution order, as in the JAX package: explicit ``path`` (``.npz`` in
    the JAX layout, or a torchvision ``.pt``/``.pth``) ->
    ``WATERNET_TPU_VGG`` -> ``weights/vgg19*`` and ``./vgg19*`` -> the
    deterministic random init, with a loud warning."""
    candidates = []
    if path is not None:
        candidates.append(Path(path))
    env = os.environ.get("WATERNET_TPU_VGG")
    if env:
        candidates.append(Path(env))
    for d in (Path("weights"), Path(".")):
        if d.is_dir():
            for pat in ("vgg19*.npz", "vgg19*.pt", "vgg19*.pth"):
                candidates.extend(sorted(d.glob(pat)))
    for c in candidates:
        if not c.exists():
            continue
        if c.suffix == ".npz":
            from waternet_tpu_torch.utils.checkpoint import load_weights
            from waternet_tpu_torch.utils.convert import vgg_state_dict_from_jax

            return vgg_state_dict_from_jax(load_weights(c))
        with open(c, "rb") as f:
            sd = torch.load(f, map_location="cpu", weights_only=True)
        return features_state_dict(sd.state_dict() if hasattr(sd, "state_dict") else sd)
    if verbose:
        print(
            "[waternet_tpu_torch] WARNING: no VGG19 weights found — using a "
            "deterministic random-feature perceptual loss. For "
            "reference-parity training, provide torchvision vgg19 weights "
            "via --vgg-weights / WATERNET_TPU_VGG.",
            file=sys.stderr,
        )
    return init_vgg_params()
