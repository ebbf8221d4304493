"""Plain float32 forwards of the benchmark's networks, from their published
descriptions: WaterNet's gated fusion (Li et al., arXiv:1901.05495), the
CAN context-aggregation network (Chen, Xu and Koltun, arXiv:1709.00643)
and VGG19's features through relu5_4 for the perceptual loss.

Each takes a dict of weights keyed as the benchmark makes them (OIHW
weights, ``<layer>.weight`` and ``<layer>.bias``) and NCHW float tensors,
and calls ``conv`` for every convolution, so a control can round the
convolutions' operands to a lower precision. Nothing here imports the
program under test.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d(x, w, b, padding=0, dilation=1):
    """The reference convolution: float32, TF32 off (set by the caller)."""
    return F.conv2d(x, w, b, padding=padding, dilation=dilation)


def waternet(params, spec, x, wb, ce, gc, conv=conv2d):
    """WaterNet on four NCHW [0, 1] batches -> NCHW float32 output.

    ``spec``: the configuration's ``cmg`` and ``refiner`` layer lists of
    ``[cin, cout, kernel]``. The confidence-map generator runs ReLU after
    every convolution but the last, which runs a sigmoid and yields one
    map per refined input; each refiner runs ReLU after all three."""
    h = torch.cat([x, wb, ce, gc], dim=1)
    cmg = spec["cmg"]
    for i, (_, _, k) in enumerate(cmg, start=1):
        h = conv(h, params[f"cmg.conv{i}.weight"], params[f"cmg.conv{i}.bias"], padding=k // 2)
        h = torch.sigmoid(h) if i == len(cmg) else torch.relu(h)

    def refine(name, variant):
        r = torch.cat([x, variant], dim=1)
        for i, (_, _, k) in enumerate(spec["refiner"], start=1):
            r = torch.relu(conv(r, params[f"{name}.conv{i}.weight"], params[f"{name}.conv{i}.bias"],
                                padding=k // 2))
        return r

    return (refine("wb_refiner", wb) * h[:, 0:1] + refine("ce_refiner", ce) * h[:, 1:2]
            + refine("gc_refiner", gc) * h[:, 2:3])


def can_dilations(depth: int) -> list:
    """CAN's dilation schedule: 1, 2, 4, ..., 2^(depth-2), then 1."""
    return [2 ** i for i in range(depth - 1)] + [1]


def can(params, width: int, depth: int, x, conv=conv2d):
    """CAN on an NCHW [0, 1] batch: ``depth`` dilated 3x3 convolutions with
    LeakyReLU(0.2), a 1x1 head to 3 channels, added to the input."""
    h = x
    for i, d in enumerate(can_dilations(depth)):
        h = F.leaky_relu(conv(h, params[f"layers.{i}.weight"], params[f"layers.{i}.bias"],
                              padding=d, dilation=d), 0.2)
    return x + conv(h, params[f"layers.{depth}.weight"], params[f"layers.{depth}.bias"])


#: VGG19's convolution widths; "M" a 2x2 max-pool. The last pool is cut:
#: the perceptual loss reads relu5_4.
VGG19 = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def vgg19_layers() -> list:
    """[(torchvision ``features`` index, cin, cout)] of the 16 convolutions."""
    out, idx, cin = [], 0, 3
    for v in VGG19:
        if v == "M":
            idx += 1
        else:
            out.append((idx, cin, v))
            cin, idx = v, idx + 2
    return out


def vgg19_features(params, x, conv=conv2d):
    """NCHW [0, 1] images -> relu5_4 features, after ImageNet normalisation."""
    mean = torch.tensor(IMAGENET_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=x.device).view(1, 3, 1, 1)
    h = (x - mean) / std
    layers = iter(vgg19_layers())
    for v in VGG19:
        if v == "M":
            h = F.max_pool2d(h, 2, 2)
        else:
            idx, _, _ = next(layers)
            h = torch.relu(conv(h, params[f"features.{idx}.weight"], params[f"features.{idx}.bias"],
                                padding=1))
    return h
