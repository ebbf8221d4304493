"""``train --debug-nans``: stop at the first operation that makes a NaN.

The counterpart of JAX's ``jax_debug_nans``. :class:`NanCheckMode` is a
``TorchDispatchMode``: it sees every ATen operation dispatched on the
thread that entered it (forward, backward and optimizer alike; the
autograd engine carries the mode into its own threads), and raises
``FloatingPointError`` naming the operation at the first floating-point
output that holds a NaN. ``torch.autograd.detect_anomaly`` checks the
backward only. Each check reads a flag back from the device, so a run
under the mode is much slower; it is for finding where a run diverges.

Operations that return uninitialized memory (``empty`` and its kin) are
not checked: their bytes are whatever the allocator held. A CUDA
kernel's output is checked at the first ATen operation that reads it.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_UNINITIALIZED = ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
                  "resize_", "set_")


class NanCheckMode(TorchDispatchMode):
    """Raise ``FloatingPointError`` at the first op output holding a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ not in _UNINITIALIZED:
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor) and t.is_floating_point() and bool(torch.isnan(t).any()):
                    raise FloatingPointError(f"invalid value (nan) encountered in {func}")
        return out
