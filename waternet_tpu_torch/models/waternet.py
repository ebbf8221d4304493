"""WaterNet: gated fusion of three refined enhancement branches (fp32).

The same math as the JAX package's Flax model (waternet_tpu/models/
waternet.py:34-93), as ``nn.Module``s whose submodule and attribute names
are the reference's torch keys, ``{cmg,wb_refiner,ce_refiner,gc_refiner}.
conv{k}.{weight,bias}`` — so the reference's exported state_dict loads with
``load_state_dict`` as is. Convolutions go to cuDNN; the JAX package left
them to XLA too. 1,090,668 parameters.

Where the bias and activation run follows what the forward can observe
(``ops/kernels.py::kernel_route``). On a CUDA input with grad off
(inference, the engines, serving, the distillation teacher) and nothing
tracing the module, each convolution runs in cuDNN without its bias, and one
hand-written in-place pass, ``ops/kernels.py::conv_bias_act``, adds the
bias and applies the ReLU or the sigmoid, to the bytes ATen's separate
passes give: 17 launches a forward. XLA fused both into its convolutions;
PyTorch's cuDNN path would run them as two more passes over every output.
Elsewhere (the CPU, training under grad, ``torch.export`` and
``torch.compile``) the forward is ``nn.Conv2d``'s biased convolution
followed by ``torch.relu``/``torch.sigmoid``.

Inputs and output are NHWC, as at every public function of the port; the
model permutes to NCHW inside, so the convolutions run channels-last.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from waternet_tpu_torch.ops.kernels import conv_bias_act, kernel_route

# (in, out, kernel) per conv; the reference's net.py:12-70 and the JAX
# package's _CMG_SPEC / _REFINER_SPEC.
_CMG_SPEC = (
    (12, 128, 7), (128, 128, 5), (128, 128, 3), (128, 64, 1),
    (64, 64, 7), (64, 64, 5), (64, 64, 3), (64, 3, 3),
)
_REFINER_SPEC = ((6, 32, 7), (32, 32, 5), (32, 3, 3))


_ACTS = {"relu": torch.relu, "sigmoid": torch.sigmoid}


def _add_convs(module: nn.Module, spec) -> None:
    for i, (cin, cout, k) in enumerate(spec):
        module.add_module(f"conv{i + 1}", nn.Conv2d(cin, cout, k, padding=k // 2))


def conv_act(conv: nn.Conv2d, x: torch.Tensor, act: str, fused: bool) -> torch.Tensor:
    """``act(conv(x))``; ``fused``: cuDNN's convolution without the bias,
    then the bias and ``act`` in one in-place pass over its output."""
    if not fused:
        return _ACTS[act](conv(x))
    y = F.conv2d(x, conv.weight, None, conv.stride, conv.padding, conv.dilation, conv.groups)
    return conv_bias_act(y, conv.bias, act)


class ConfidenceMapGenerator(nn.Module):
    """NCHW 12-channel input -> three (N, 1, H, W) confidence maps."""

    def __init__(self):
        super().__init__()
        _add_convs(self, _CMG_SPEC)
        self.n_convs = len(_CMG_SPEC)

    def forward(self, x):
        fused = kernel_route(x)
        if fused:
            x = x.contiguous(memory_format=torch.channels_last)
        for i in range(1, self.n_convs):
            x = conv_act(getattr(self, f"conv{i}"), x, "relu", fused)
        out = conv_act(getattr(self, f"conv{self.n_convs}"), x, "sigmoid", fused)
        return out[:, 0:1], out[:, 1:2], out[:, 2:3]


class Refiner(nn.Module):
    """NCHW concat(x, variant) 6-channel input -> refined 3-channel image."""

    def __init__(self):
        super().__init__()
        _add_convs(self, _REFINER_SPEC)

    def forward(self, x):
        fused = kernel_route(x)
        if fused:
            x = x.contiguous(memory_format=torch.channels_last)
        x = conv_act(self.conv1, x, "relu", fused)
        x = conv_act(self.conv2, x, "relu", fused)
        return conv_act(self.conv3, x, "relu", fused)


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
