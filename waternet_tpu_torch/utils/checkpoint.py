"""Flat-npz weights, the JAX package's weights-only format, both ways.

Keys are ``/``-joined tree paths (``params/cmg/Conv_0/kernel``), HWIO
kernels. A filename carrying a ``-<6 hex>`` suffix is verified against the
first 6 hex chars of the file's sha256, the reference's hash-in-filename
convention. :func:`save_weights` writes the same layout, so the JAX
package and the port each load the other's ``last.npz``.
"""

from __future__ import annotations

import hashlib
import os
import re
from pathlib import Path

import numpy as np


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
    kernels under ``params/{module}/Conv_i``), atomically: a temp file in
    the same directory, then ``os.replace``."""
    from waternet_tpu_torch.utils.convert import jax_from_state_dict

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.parent / f".{path.name}.tmp.npz"
    try:
        np.savez(tmp, **flatten(jax_from_state_dict(state_dict)))
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    return path
