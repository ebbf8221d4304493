"""Serialized deployment artifacts of the inference forward (``torch.export``).

The port of the JAX package's ``export.py``. ``torch.export.export`` traces
the model forward with the weights (float, or the int8 qtree) baked in as
constants and symbolic batch, height and width (``torch.export.Dim``), so
one artifact serves every resolution; ``torch.export.save`` writes it as a
``.pt2`` ExportedProgram and :func:`load_artifact` runs it with nothing of
this package.

The artifact is an ExportedProgram, not the JAX package's StableHLO: the
two packages' artifacts are not interchangeable. It covers the MODEL
forward: ``(x, wb, ce, gc) -> out`` for WaterNet, ``(x) -> out`` for the
CAN student (``arch="can"``), all NHWC float32 in [0, 1]; preprocessing
stays a runtime choice, as in the live API. The int8 variant keeps H and
W symbolic by taking each convolution's im2col in one piece
(``models/quant.py``), so its peak memory is the widest layer's im2col;
its scales calibrate on the host, as the engines' do.

As a CLI, with the flags of the JAX package's ``tools/export_model.py``::

    python -m waternet_tpu_torch.export --weights last.npz --out waternet.pt2 \
        [--quantize] [--arch waternet|can] [--device cuda|cpu]
"""

from __future__ import annotations

from pathlib import Path

import torch
from torch import nn

_SUFFIX = ".pt2"


class _Student(nn.Module):
    """An ``nn.Module`` over the student's forward callable."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


class _Quality(_Student):
    """An ``nn.Module`` over WaterNet's forward callable (the quantized
    model and the bf16 wrapper are plain callables)."""

    def forward(self, x, wb, ce, gc):
        return self.fn(x, wb, ce, gc)


def export_forward(
    params,
    *,
    quantize: bool = False,
    calib_batches=None,
    dtype: torch.dtype = torch.float32,
    arch: str = "waternet",
    device="cuda",
):
    """-> ``torch.export.ExportedProgram`` of the inference forward on
    ``device`` with symbolic (batch, height, width) and the weights baked
    in.

    ``arch``: ``"waternet"`` (the quality model, four inputs) or ``"can"``
    (the distilled student, one input; width and depth inferred and checked
    from ``params``, so WaterNet weights exported as a student fail with a
    named diff). ``quantize=True`` bakes the static int8 forward, calibrated
    on ``calib_batches``; ``dtype=torch.bfloat16`` runs the float forward
    under bf16 autocast."""
    from waternet_tpu_torch.hub import build_model, check_dtype, run_model
    from waternet_tpu_torch.models import quant
    from waternet_tpu_torch.utils.device import resolve_device

    if calib_batches is not None and not quantize:
        raise ValueError(
            "calib_batches given without quantize=True: the calibration "
            "data would be silently dropped from a float artifact"
        )
    if arch not in ("waternet", "can"):
        raise ValueError(f"arch must be 'waternet' or 'can', got {arch!r}")
    dev = resolve_device(device)
    check_dtype(dtype)
    if arch == "can":
        from waternet_tpu_torch.models.can import student_state_dict, build_student, can_config_from_params

        sd = student_state_dict(params)
        can_config_from_params(sd)
        if quantize:
            fn = quant.QuantCAN(quant.quantize_can(sd, calib_batches, device="cpu"), dev)
        else:
            fn = build_student(sd, dev, dtype)
        arity = 1
    else:
        if quantize:
            fn = quant.QuantWaterNet(quant.quantize_waternet(params, calib_batches, device="cpu"), dev)
        else:
            model = build_model(params, dev)

            def fn(x, wb, ce, gc):
                return run_model(model, dtype, x, wb, ce, gc)

        arity = 4
    batch, h, w = torch.export.Dim("batch"), torch.export.Dim("h"), torch.export.Dim("w")
    example = tuple(torch.rand((2, 24, 32, 3), generator=torch.Generator().manual_seed(0)).to(dev) for _ in range(arity))
    shapes = tuple({0: batch, 1: h, 2: w} for _ in range(arity))
    with torch.no_grad():
        return torch.export.export((_Student if arity == 1 else _Quality)(fn).eval(), example, dynamic_shapes=shapes)


def save_artifact(path, params, **kwargs) -> Path:
    """Export and write to ``path`` (``.pt2`` appended if no suffix). Returns
    the written path."""
    path = Path(path)
    if not path.suffix:
        path = path.with_suffix(_SUFFIX)
    torch.export.save(export_forward(params, **kwargs), str(path))
    return path


def load_artifact(path):
    """-> the forward of a saved artifact, a callable of the artifact's own
    arity (``(x, wb, ce, gc)`` for WaterNet, ``(x)`` for the student) on
    NHWC float32 tensors on the device it was exported for."""
    module = torch.export.load(str(path)).module()

    def run(*args):
        with torch.no_grad():
            return module(*(torch.as_tensor(a, dtype=torch.float32) for a in args))

    return run


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Export a checkpoint as a torch.export deployment artifact (.pt2).")
    p.add_argument("--weights", default=None,
                   help="checkpoint (.npz or reference .pt); default: the standard resolution order (env, "
                   "./weights). With --arch can this must be an explicit student checkpoint (a train "
                   "--distill product)")
    p.add_argument("--out", default="waternet.pt2")
    p.add_argument("--quantize", action="store_true",
                   help="bake the int8 forward (static calibration on synthetic frames; use the library "
                   "API for custom calibration batches)")
    p.add_argument("--arch", default="waternet", choices=["waternet", "can"],
                   help="which tier's model to export: 'waternet' (quality teacher, 4-input forward) or "
                   "'can' (fast-tier distilled student, single-input; width/depth inferred and validated "
                   "from the checkpoint)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu': where the artifact runs.")
    args = p.parse_args(argv)

    from waternet_tpu_torch.hub import resolve_weights

    if args.arch == "can" and args.weights is None:
        raise SystemExit("--arch can needs an explicit --weights student checkpoint "
                         "(the implicit resolution is reserved for the teacher)")
    params = resolve_weights(args.weights)
    if params is None:
        raise SystemExit("no weights found: pass --weights or set WATERNET_TPU_WEIGHTS")
    path = save_artifact(args.out, params, quantize=args.quantize, arch=args.arch, device=args.device)
    kind = "int8" if args.quantize else "float"
    print(f"wrote {kind} {args.arch} artifact: {path} ({path.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
