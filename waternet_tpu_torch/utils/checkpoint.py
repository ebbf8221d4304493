"""Flat-npz weight loading (the JAX package's weights-only format).

Keys are ``/``-joined tree paths (``params/cmg/Conv_0/kernel``). A filename
carrying a ``-<6 hex>`` suffix is verified against the first 6 hex chars of
the file's sha256, the reference's hash-in-filename convention.
"""

from __future__ import annotations

import hashlib
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
