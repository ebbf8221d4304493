"""CAN student: a compact dilated context-aggregation network that maps raw
RGB directly to enhanced RGB — the fast serving tier.

The port of the JAX package's ``models/can.py`` (after *Fast Image
Processing with Fully-Convolutional Networks*, Chen et al.,
arXiv:1709.00643): ``depth`` 3x3 convolutions of ``width`` channels with
dilations ``1, 2, 4, ..., 2^(depth-2), 1`` and LeakyReLU(0.2), then a
linear 1x1 head to 3 channels added RESIDUALLY to the input. A 3x3
convolution at dilation d pads d on each side: Flax's ``SAME``. The
student is distilled from the whole WaterNet quality pipeline (WB, GC,
CLAHE and the gated-fusion forward; ``train --distill``), so it needs no
classical transform at all, and its forward costs 31,824 MACs a pixel
against WaterNet's 1,089,824 (:func:`flops_ratio`, ~34x).

State_dict keys are ``layers.{i}.{weight,bias}`` (OIHW weights): the
``depth`` dilated stages, then the head. ``utils/convert.py::
can_state_dict_from_jax`` maps the JAX tree's ``Conv_i/{kernel,bias}``
(HWIO) onto them. Inputs and output are NHWC, as at every public function
of the port.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from waternet_tpu_torch.models.waternet import _conv_flops, waternet_forward_flops

#: Default student shape: width 24, 7 dilated 3x3 stages (+ the 1x1 head).
DEFAULT_WIDTH = 24
DEFAULT_DEPTH = 7


def can_dilations(depth: int) -> List[int]:
    """The dilation schedule of the ``depth`` 3x3 stages: ``1, 2, 4, ...,
    2^(depth-2)`` then a closing dilation-1 stage. ``depth >= 2``."""
    if depth < 2:
        raise ValueError(f"CAN depth must be >= 2, got {depth}")
    return [2**i for i in range(depth - 1)] + [1]


def can_receptive_radius(depth: int = DEFAULT_DEPTH) -> int:
    """Receptive-field radius in pixels (64 at depth 7): each 3x3 stage at
    dilation d widens the field by d a side. The fast tier's counterpart of
    ``serving.RECEPTIVE_RADIUS``: an output pixel farther than this from a
    pad seam never sees padded content."""
    return sum(can_dilations(depth))


class CANStudent(nn.Module):
    """``model(x)``: an (N, H, W, 3) float tensor in [0, 1] -> (N, H, W, 3)
    float32. ``dtype=torch.bfloat16`` runs the convolutions under bf16
    autocast (parameters stay float32), as the JAX module's ``dtype`` does;
    the residual add runs in float32 either way."""

    def __init__(self, width: int = DEFAULT_WIDTH, depth: int = DEFAULT_DEPTH, dtype: torch.dtype = torch.float32):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {dtype}")
        self.width, self.depth, self.dtype = int(width), int(depth), dtype
        layers, cin = [], 3
        for d in can_dilations(depth):
            layers.append(nn.Conv2d(cin, width, 3, padding=d, dilation=d))
            cin = width
        layers.append(nn.Conv2d(cin, 3, 1))
        self.layers = nn.ModuleList(layers)

    def _delta(self, h: torch.Tensor) -> torch.Tensor:
        for conv in self.layers[:-1]:
            h = F.leaky_relu(conv(h), negative_slope=0.2)
        return self.layers[-1](h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2)
        if self.dtype == torch.float32:
            delta = self._delta(h)
        else:
            with torch.autocast(x.device.type, dtype=self.dtype):
                delta = self._delta(h)
        return x.to(torch.float32) + delta.to(torch.float32).permute(0, 2, 3, 1)


# ----------------------------------------------------------------------
# FLOP accounting, from the same layer specs the module is built from.
# ----------------------------------------------------------------------


def can_forward_flops(h: int, w: int, width: int = DEFAULT_WIDTH, depth: int = DEFAULT_DEPTH) -> int:
    """Per-image forward FLOPs of the student at (h, w) (dilation does not
    change the MACs)."""
    total, cin = 0, 3
    for _ in can_dilations(depth):
        total += _conv_flops(h, w, cin, width, 3)
        cin = width
    return total + _conv_flops(h, w, cin, 3, 1)


def teacher_pipeline_flops(h: int, w: int) -> int:
    """Per-image FLOPs of the quality pipeline the student replaces,
    counted as the WaterNet forward alone: WB/GC/CLAHE are byte-bound, and
    their FLOPs would barely move the ratio."""
    return waternet_forward_flops(h, w)


def flops_ratio(h: int = 112, w: int = 112, width: int = DEFAULT_WIDTH, depth: int = DEFAULT_DEPTH) -> float:
    """Teacher-pipeline FLOPs over student FLOPs at (h, w): ~34x for the
    default student."""
    return teacher_pipeline_flops(h, w) / can_forward_flops(h, w, width, depth)


def train_flops_per_image(
    h: int, w: int, width: int = DEFAULT_WIDTH, depth: int = DEFAULT_DEPTH, distill: bool = False
) -> int:
    """Per-image FLOPs of one training step: the student forward and
    backward (3x the forward), plus the frozen teacher's forward under
    distillation."""
    total = 3 * can_forward_flops(h, w, width, depth)
    if distill:
        total += waternet_forward_flops(h, w)
    return total


# ----------------------------------------------------------------------
# Param-tree validation: "these weights are not a student".
# ----------------------------------------------------------------------

_WATERNET_BRANCHES = ("cmg", "wb_refiner", "ce_refiner", "gc_refiner")


def student_state_dict(params) -> dict:
    """A port state_dict (``layers.*``) as is, or the JAX tree (nested or
    flat keys) converted; raises ValueError for anything else, loudly for
    WaterNet weights."""
    if not isinstance(params, dict) or not params:
        raise ValueError("student weights are not a CAN param tree (empty or non-dict)")
    names = {k.split(".")[0].split("/")[0] for k in params}
    inner_names = set()
    if "params" in names:
        inner = params.get("params")
        if isinstance(inner, dict):
            inner_names = set(inner)
        else:
            inner_names = {k.split("/")[1] for k in params if k.startswith("params/")}
    if set(_WATERNET_BRANCHES) & (names | inner_names):
        raise ValueError(
            "these are quality-tier WaterNet weights (cmg/*_refiner branches), not a CAN "
            "student checkpoint: pass them to the quality engine (--weights), and point "
            "--student-weights at a distilled student (train --distill)"
        )
    if names == {"layers"}:
        return params
    from waternet_tpu_torch.utils.convert import can_state_dict_from_jax

    keys = inner_names or names
    if not keys or any(not n.startswith("Conv_") for n in keys):
        raise ValueError(
            "not a CAN student param tree: unexpected top-level keys "
            f"{sorted(n for n in keys if not n.startswith('Conv_'))}"
        )
    return can_state_dict_from_jax(params)


def can_config_from_params(params) -> Tuple[int, int]:
    """Infer ``(width, depth)`` from a student state_dict or JAX tree and
    check that it fits :class:`CANStudent` exactly, through the same
    mismatch report the trainer's restore and the server's reload use.
    Raises ValueError with the named diff, and a loud tier-mismatch message
    when given WaterNet weights."""
    from waternet_tpu_torch.utils.checkpoint import params_mismatch_report

    sd = student_state_dict(params)
    n_convs = len({k.split(".")[1] for k in sd})
    depth = n_convs - 1  # the 1x1 head is the last conv
    try:
        width = int(sd["layers.0.weight"].shape[0])
        can_dilations(depth)
    except (KeyError, AttributeError, IndexError, ValueError) as err:
        raise ValueError(f"malformed CAN student param tree: {err}") from None
    report = params_mismatch_report(sd, CANStudent(width, depth).state_dict())
    if report:
        raise ValueError(f"student weights do not fit CANStudent(width={width}, depth={depth}):\n{report}")
    return width, depth


def build_student(params, device, dtype: torch.dtype = torch.float32) -> CANStudent:
    """A :class:`CANStudent` on ``device`` in eval mode with ``params`` (a
    state_dict or the JAX tree) loaded; width and depth from the weights."""
    sd = student_state_dict(params)
    width, depth = can_config_from_params(sd)
    model = CANStudent(width, depth, dtype)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()}, strict=True)
    return model.to(device).eval()
