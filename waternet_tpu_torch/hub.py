"""The public Python API: ``preprocess, postprocess, model = waternet(...)``.

The reference's torchhub contract, with the JAX package's NHWC layout:
``preprocess`` maps one uint8 HWC RGB array to ``(rgb, wb, he, gc)``, the
positional order the model consumes; ``postprocess`` maps the model output
back to uint8. Nothing downloads: weights resolve from an explicit path,
``WATERNET_TPU_WEIGHTS``, or a ``.npz`` / reference ``.pt`` in ``.`` or
``./weights``.

Example::

    from waternet_tpu_torch.hub import waternet
    preprocess, postprocess, model = waternet(weights="teacher.npz")
    rgb_t, wb_t, he_t, gc_t = preprocess(rgb)     # (1, H, W, 3) float32
    with torch.inference_mode():
        out = model(rgb_t, wb_t, he_t, gc_t)      # (1, H, W, 3) in [0, 1]
    out_im = postprocess(out)                     # (1, H, W, 3) uint8

``dtype=torch.bfloat16`` returns the model as a callable that runs it
under bf16 autocast (fp32 parameters) and returns float32, as the JAX
hub's ``dtype`` does.
"""

from __future__ import annotations

import functools
import os
from pathlib import Path
from typing import Callable, Tuple

import torch

from waternet_tpu_torch.models import WaterNet
from waternet_tpu_torch.ops.transform import transform_np
from waternet_tpu_torch.utils.checkpoint import load_weights
from waternet_tpu_torch.utils.convert import can_state_dict_from_jax, is_can_tree, state_dict_from_jax
from waternet_tpu_torch.utils.device import resolve_device
from waternet_tpu_torch.utils.tensor import arr2ten, ten2arr


def find_weights_path(search_dirs=(".", "weights")) -> Path | None:
    """Locate (but do not load) the implicit-resolution weight candidate."""
    candidates = []
    for d in search_dirs:
        d = Path(d)
        if d.is_dir():
            candidates.extend(sorted(d.glob("waternet_tpu-*.npz")))
            candidates.extend(sorted(d.glob("waternet_exported_state_dict*.pt")))
            # Broad fallback, excluding VGG19 perceptual-loss weight files.
            candidates.extend(
                p
                for pat in ("*.npz", "*.pt")
                for p in sorted(d.glob(pat))
                if not p.name.lower().startswith("vgg")
            )
    for c in candidates:
        if c.exists() and c.suffix in (".npz", ".pt", ".pth"):
            return c
    return None


def _load_strict(path: Path, origin: str) -> dict[str, torch.Tensor]:
    if not path.exists():
        raise FileNotFoundError(f"{origin} path does not exist: {path}")
    if path.suffix == ".npz":
        tree = load_weights(path)
        return can_state_dict_from_jax(tree) if is_can_tree(tree) else state_dict_from_jax(tree)
    if path.suffix in (".pt", ".pth"):
        with open(path, "rb") as f:
            sd = torch.load(f, map_location="cpu", weights_only=True)
        return dict(sd.state_dict() if hasattr(sd, "state_dict") else sd)
    raise ValueError(
        f"{origin} path has unsupported suffix {path.suffix!r} "
        f"(expected .npz or .pt/.pth): {path}"
    )


def resolve_weights(
    weights=None, search_dirs=(".", "weights")
) -> dict[str, torch.Tensor] | None:
    """Find and load weights as a state_dict, or None.

    ``.npz`` is the JAX package's flat format (converted HWIO -> OIHW; a
    CAN student's tree becomes ``CANStudent``'s ``layers.*`` keys);
    ``.pt``/``.pth`` is the reference's state_dict, whose keys the port's
    model shares. An explicitly named path (argument or env var) that does
    not exist raises rather than falling through to ``./weights``.
    """
    if weights is not None:
        return _load_strict(Path(weights), "weights")
    env = os.environ.get("WATERNET_TPU_WEIGHTS")
    if env:
        return _load_strict(Path(env), "WATERNET_TPU_WEIGHTS")
    found = find_weights_path(search_dirs)
    return _load_strict(found, "discovered") if found is not None else None


def build_model(state_dict, device) -> WaterNet:
    """A WaterNet on ``device`` in eval mode with ``state_dict`` loaded."""
    model = WaterNet()
    model.load_state_dict(state_dict, strict=True)
    return model.to(device).eval()


def init_state_dict(seed: int = 0) -> dict[str, torch.Tensor]:
    """A WaterNet state_dict from ``torch``'s default init under ``seed``,
    leaving the global generator as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return WaterNet().state_dict()


#: The model's compute dtypes: float32, or bf16 autocast over fp32 parameters.
DTYPES = (torch.float32, torch.bfloat16)


def check_dtype(dtype: torch.dtype) -> torch.dtype:
    """``dtype`` if it is one of :data:`DTYPES`, else ValueError."""
    if dtype not in DTYPES:
        raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {dtype}")
    return dtype


def run_model(model: WaterNet, dtype: torch.dtype, x, wb, ce, gc) -> torch.Tensor:
    """``model(x, wb, ce, gc)`` in ``dtype``: bf16 under autocast on the
    inputs' device, cast back to float32 at the boundary as the JAX model
    casts its output."""
    if dtype == torch.float32:
        return model(x, wb, ce, gc)
    with torch.autocast(x.device.type, dtype=dtype):
        out = model(x, wb, ce, gc)
    return out.to(torch.float32)


def waternet(
    pretrained: bool = True, weights=None, device="cuda", dtype: torch.dtype = torch.float32
) -> Tuple[Callable, Callable, Callable]:
    """Build the ``(preprocess, postprocess, model)`` triple on ``device``.

    ``pretrained=False`` gives a model initialised from ``torch``'s default
    scheme under seed 0. ``dtype=torch.float32`` returns the ``WaterNet``
    module itself; ``torch.bfloat16`` a callable that runs it under bf16
    autocast and returns float32.
    """
    dev = resolve_device(device)
    check_dtype(dtype)
    if pretrained:
        sd = resolve_weights(weights)
        if sd is None:
            raise FileNotFoundError(
                "No WaterNet weights found. Provide `weights=...`, set "
                "WATERNET_TPU_WEIGHTS, or place waternet_tpu-*.npz / the "
                "reference's waternet_exported_state_dict-*.pt in ./weights. "
                "Nothing is downloaded."
            )
    else:
        sd = init_state_dict(0)

    def preprocess(rgb_arr):
        wb, gc, he = transform_np(rgb_arr)
        return tuple(arr2ten(a, dev) for a in (rgb_arr, wb, he, gc))

    def postprocess(model_out):
        return ten2arr(model_out)

    model = build_model(sd, dev)
    if dtype == torch.float32:
        return preprocess, postprocess, model
    return preprocess, postprocess, functools.partial(run_model, model, dtype)


def waternet_student(
    weights, device="cuda", dtype: torch.dtype = torch.float32
) -> Tuple[Callable, Callable, Callable]:
    """Build the fast tier's ``(preprocess, postprocess, model)`` triple.

    ``weights`` must name a distilled student checkpoint explicitly (a
    ``train --distill`` product): the implicit resolution is the teacher's,
    so the two tiers never swap checkpoints silently. The tree is checked
    against ``CANStudent`` (width and depth inferred), with a named shape
    diff and a loud tier-mismatch message for WaterNet weights.
    ``preprocess`` maps one uint8 HWC RGB array to a (1, H, W, 3) float32
    tensor in [0, 1] on ``device``; ``model(x)`` is the ``CANStudent``
    (``dtype=torch.bfloat16``: bf16 autocast, float32 out)."""
    from waternet_tpu_torch.models.can import build_student

    dev = resolve_device(device)
    check_dtype(dtype)
    if weights is None:
        raise FileNotFoundError(
            "waternet_student needs an explicit student checkpoint path "
            "(a train --distill product)"
        )
    model = build_student(resolve_weights(weights), dev, dtype)

    def preprocess(rgb_arr):
        return arr2ten(rgb_arr, dev)

    def postprocess(model_out):
        return ten2arr(model_out)

    return preprocess, postprocess, model


def restormer_params(weights=None, params=None) -> dict:
    """Restormer's state_dict from ``params`` (a loaded state_dict) or the
    ``weights`` path (``.pth``/``.pt``, official layout, bare or under
    ``params``). One of the two must be given: no Restormer checkpoint is
    resolved implicitly, and none is bundled."""
    from waternet_tpu_torch.models.restormer import restormer_state_dict

    if params is None:
        if weights is None:
            raise FileNotFoundError(
                "Restormer needs explicit weights: pass weights=PATH (the official "
                "state_dict, e.g. basicsr's .pth, loads strictly) or params=state_dict"
            )
        params = resolve_weights(weights)
    return restormer_state_dict(params)


def restormer(
    weights=None, params=None, dtype: torch.dtype = torch.float32, device="cuda"
) -> Tuple[Callable, Callable, Callable]:
    """Build Restormer's ``(preprocess, postprocess, model)`` triple
    (``models/restormer.py``). ``weights``/``params`` as
    :func:`restormer_params` takes them; the configuration comes from the
    weights. ``preprocess`` maps one uint8 HWC RGB array to a (1, H, W, 3)
    float32 tensor in [0, 1] on ``device``; ``model(x)`` is the
    ``Restormer`` (``dtype=torch.bfloat16``: bf16 autocast over fp32
    parameters, float32 out). Each frame runs whole: its attention is
    global over the frame."""
    from waternet_tpu_torch.models.restormer import build_restormer

    dev = resolve_device(device)
    check_dtype(dtype)
    model = build_restormer(restormer_params(weights, params), dev, dtype)

    def preprocess(rgb_arr):
        return arr2ten(rgb_arr, dev)

    def postprocess(model_out):
        return ten2arr(model_out)

    return preprocess, postprocess, model
