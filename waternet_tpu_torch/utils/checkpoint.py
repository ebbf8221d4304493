"""Checkpoint I/O: the JAX package's weights-only npz both ways, and the
port's full train state.

**Weights only.** Keys are ``/``-joined tree paths (``params/cmg/Conv_0/kernel``), HWIO
kernels. A filename carrying a ``-<6 hex>`` suffix is verified against the
first 6 hex chars of the file's sha256, the reference's hash-in-filename
convention. :func:`save_weights` writes the same layout, so the JAX
package and the port each load the other's ``last.npz``.

**Full train state** (what ``--resume`` restores; the JAX package keeps it
in an Orbax tree, which the port does not read): a directory holding one
``state.pt``, ``torch.save`` of ``{"model", "optimizer", "scheduler",
"step"}`` (the WaterNet, ``torch.optim.Adam`` and ``LambdaLR``
state_dicts, and the optimizer step count) with every tensor on the CPU.
:func:`save_state_atomic` writes it to a temporary sibling and puts it in
place with ``os.replace``; :func:`load_state` reads it with
``weights_only=True``. JAX state crosses over through
:func:`waternet_tpu_torch.utils.convert.train_state_from_jax`.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
from pathlib import Path

import numpy as np
import torch

STATE_FILE = "state.pt"


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, val in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def load_weights(path) -> dict:
    """Load a flat npz into a nested dict of numpy arrays, verifying an
    embedded ``-<6 hex>`` content hash when the filename has one."""
    path = Path(path)
    m = re.search(r"-([0-9a-f]{6})\.npz$", path.name)
    if m:
        digest = hashlib.sha256(path.read_bytes()).hexdigest()[:6]
        if digest != m.group(1):
            raise ValueError(
                f"checkpoint hash mismatch for {path.name}: file hashes to {digest}"
            )
    with np.load(path) as data:
        return unflatten({k: data[k] for k in data.files})


def flatten(tree: dict, prefix: str = "") -> dict:
    """Nested dict -> flat ``a/b/c`` keys (the inverse of :func:`unflatten`)."""
    flat = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(val, dict):
            flat.update(flatten(val, path))
        else:
            flat[path] = val
    return flat


def save_weights(state_dict: dict, path) -> Path:
    """Save a WaterNet state_dict as the JAX package's flat npz (HWIO
    kernels under ``params/{module}/Conv_i``), or a CAN student's
    (``layers.*`` keys) under ``params/Conv_i``, atomically: a temp file in
    the same directory, then ``os.replace``."""
    from waternet_tpu_torch.utils.convert import jax_from_can_state_dict, jax_from_state_dict

    to_jax = jax_from_can_state_dict if "layers.0.weight" in state_dict else jax_from_state_dict

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.parent / f".{path.name}.tmp.npz"
    try:
        np.savez(tmp, **flatten(to_jax(state_dict)))
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    return path


def param_shapes(tree: dict, with_dtype: bool = False) -> dict:
    """Flat ``{name: shape}`` (or ``(shape, dtype)``) view of a state_dict
    or nested dict of arrays: the vocabulary of every "does this checkpoint
    fit this model" check."""
    out = {}
    for key, leaf in flatten(dict(tree)).items():
        shape = tuple(leaf.shape)
        out[key] = (shape, str(leaf.dtype).removeprefix("torch.")) if with_dtype else shape
    return out


def params_mismatch_report(ckpt_params: dict, model_params: dict, check_dtype: bool = False) -> str:
    """Human-readable diff of two state_dicts; the empty string when they
    fit. Names each tensor that is missing, extra or of another shape
    (and dtype, with ``check_dtype``)."""
    ck = param_shapes(ckpt_params, with_dtype=check_dtype)
    mo = param_shapes(model_params, with_dtype=check_dtype)
    lines = []
    for key in sorted(set(ck) | set(mo)):
        if key not in ck:
            lines.append(f"  missing from checkpoint: {key} (model {mo[key]})")
        elif key not in mo:
            lines.append(f"  not in model: {key} (checkpoint {ck[key]})")
        elif ck[key] != mo[key]:
            what = "shape/dtype" if check_dtype else "shape"
            lines.append(f"  {what} mismatch at {key}: checkpoint {ck[key]} vs model {mo[key]}")
    return "\n".join(lines)


def _to_cpu(value):
    """A copy of a state tree with every tensor cloned to the CPU."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", copy=True)
    if isinstance(value, dict):
        return {k: _to_cpu(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_to_cpu(v) for v in value)
    return value


def save_state_atomic(state: dict, path) -> Path:
    """Save a train-state dict as the directory ``path`` holding
    ``state.pt``, its tensors copied to the CPU. Atomic: written and
    fsynced in a ``.tmp-`` sibling, then put in place with ``os.replace``,
    so a crash mid-save leaves the old ``path`` or none, never half a
    state."""
    path = Path(path).absolute()
    tmp = path.parent / f".tmp-{path.name}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    with open(tmp / STATE_FILE, "wb") as f:
        torch.save(_to_cpu(state), f)
        f.flush()
        os.fsync(f.fileno())
    if path.exists():
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path


def load_state(path, map_location=None) -> dict:
    """Read what :func:`save_state_atomic` wrote at ``path`` (tensors
    only, no code: ``weights_only=True``), onto ``map_location``."""
    return torch.load(Path(path) / STATE_FILE, map_location=map_location, weights_only=True)
