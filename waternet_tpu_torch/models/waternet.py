"""WaterNet: gated fusion of three refined enhancement branches (fp32).

The same math as the JAX package's Flax model (waternet_tpu/models/
waternet.py:34-93), as ``nn.Module``s whose submodule and attribute names
are the reference's torch keys, ``{cmg,wb_refiner,ce_refiner,gc_refiner}.
conv{k}.{weight,bias}`` — so the reference's exported state_dict loads with
``load_state_dict`` as is. Convolutions go to cuDNN through ``nn.Conv2d``;
the JAX package left them to XLA too. 1,090,668 parameters.

Inputs and output are NHWC, as at every public function of the port; the
model permutes to NCHW inside.
"""

from __future__ import annotations

import torch
from torch import nn

# (in, out, kernel) per conv; the reference's net.py:12-70 and the JAX
# package's _CMG_SPEC / _REFINER_SPEC.
_CMG_SPEC = (
    (12, 128, 7), (128, 128, 5), (128, 128, 3), (128, 64, 1),
    (64, 64, 7), (64, 64, 5), (64, 64, 3), (64, 3, 3),
)
_REFINER_SPEC = ((6, 32, 7), (32, 32, 5), (32, 3, 3))


def _add_convs(module: nn.Module, spec) -> None:
    for i, (cin, cout, k) in enumerate(spec):
        module.add_module(f"conv{i + 1}", nn.Conv2d(cin, cout, k, padding=k // 2))


class ConfidenceMapGenerator(nn.Module):
    """NCHW 12-channel input -> three (N, 1, H, W) confidence maps."""

    def __init__(self):
        super().__init__()
        _add_convs(self, _CMG_SPEC)
        self.n_convs = len(_CMG_SPEC)

    def forward(self, x):
        for i in range(1, self.n_convs):
            x = torch.relu(getattr(self, f"conv{i}")(x))
        out = torch.sigmoid(getattr(self, f"conv{self.n_convs}")(x))
        return out[:, 0:1], out[:, 1:2], out[:, 2:3]


class Refiner(nn.Module):
    """NCHW concat(x, variant) 6-channel input -> refined 3-channel image."""

    def __init__(self):
        super().__init__()
        _add_convs(self, _REFINER_SPEC)

    def forward(self, x):
        x = torch.relu(self.conv1(x))
        x = torch.relu(self.conv2(x))
        return torch.relu(self.conv3(x))


def _conv_flops(h: int, w: int, cin: int, cout: int, k: int) -> int:
    """2 * MACs of one SAME k x k conv over an (h, w) plane."""
    return 2 * h * w * cin * cout * k * k


def waternet_forward_flops(h: int, w: int) -> int:
    """Per-image forward FLOPs of WaterNet at (h, w), from the layer specs:
    the confidence-map generator and the three refiners (the JAX
    package's ``models/can.py::waternet_forward_flops``)."""
    cmg = sum(_conv_flops(h, w, cin, cout, k) for cin, cout, k in _CMG_SPEC)
    refiner = sum(_conv_flops(h, w, cin, cout, k) for cin, cout, k in _REFINER_SPEC)
    return cmg + 3 * refiner


class WaterNet(nn.Module):
    """``model(x, wb, ce, gc)``: four (N, H, W, 3) float tensors in [0, 1]
    (``ce`` is the histogram-equalized variant) -> (N, H, W, 3) float32."""

    def __init__(self):
        super().__init__()
        self.cmg = ConfidenceMapGenerator()
        self.wb_refiner = Refiner()
        self.ce_refiner = Refiner()
        self.gc_refiner = Refiner()

    def forward(self, x, wb, ce, gc):
        x, wb, ce, gc = (t.permute(0, 3, 1, 2) for t in (x, wb, ce, gc))
        wb_cm, ce_cm, gc_cm = self.cmg(torch.cat([x, wb, ce, gc], dim=1))
        out = (
            self.wb_refiner(torch.cat([x, wb], dim=1)) * wb_cm
            + self.ce_refiner(torch.cat([x, ce], dim=1)) * ce_cm
            + self.gc_refiner(torch.cat([x, gc], dim=1)) * gc_cm
        )
        return out.permute(0, 2, 3, 1)
