"""Device resolution for the port's entry points.

``cuda`` is the default; ``cpu`` runs only when the caller asks for it (the
tests do). A CUDA request on a machine without CUDA raises instead of
carrying on on the CPU. On CUDA, TF32 is switched off for both cuDNN
convolutions (whose default is TF32) and cuBLAS matmuls: fp32 parity with
the JAX reference needs full fp32 products.
"""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device="cuda") -> torch.device:
    """``"cuda"`` / ``"cuda:K"`` / ``"cpu"`` (or a ``torch.device``) ->
    ``torch.device``, with the CUDA numerics switches set."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} was requested but CUDA is not "
                "available (torch.cuda.is_available() is False); pass "
                "device='cpu' to run the plain PyTorch path on the CPU"
            )
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: use 'cuda' or 'cpu'")
    return dev


def gpu_card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them (first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    ).stdout
    return out.strip().splitlines()[0]
