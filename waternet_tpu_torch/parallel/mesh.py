"""A (data, spatial) grid of torch devices, and the batch padding helper.

The port of the JAX package's ``parallel/mesh.py``. JAX's ``Mesh`` names
the axes of a device grid and XLA partitions programs over it; PyTorch has
no partitioner, so here the grid is plain bookkeeping that the sharded
paths read:

* the **data** axis: batch sharding. Inference splits a frame batch over
  it with a model replica on each device; training runs one process per
  data shard under ``DistributedDataParallel``
  (:mod:`waternet_tpu_torch.parallel.distributed`);
* the **spatial** axis: H sharding of each image, with the halo scheme of
  :mod:`waternet_tpu_torch.parallel.spatial`.

A ``devices`` list may repeat a device: ``make_mesh(1, 4, ["cuda:0"] * 4)``
is four spatial shards on one card, ``["cpu"] * 8`` eight on the CPU. That
is the rehearsal layout, the counterpart of the JAX tests'
``--xla_force_host_platform_device_count``: the same windows, copies and
crops run, on fewer devices.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"


class Mesh:
    """An ``(n_data, n_spatial)`` grid of ``torch.device``s.

    ``shape`` maps each axis name to its size, as JAX's ``Mesh.shape``
    does; ``devices`` is the grid (an object array), row ``i`` the spatial
    group of data shard ``i``."""

    axis_names = (DATA_AXIS, SPATIAL_AXIS)

    def __init__(self, grid: np.ndarray):
        self.devices = grid
        self.shape = {DATA_AXIS: grid.shape[0], SPATIAL_AXIS: grid.shape[1]}

    def data_devices(self) -> list:
        """The first device of each data shard's spatial group."""
        return [self.devices[i, 0] for i in range(self.shape[DATA_AXIS])]

    def spatial_devices(self, data_index: int = 0) -> list:
        """The spatial group of one data shard, in slab order."""
        return list(self.devices[data_index])

    def __repr__(self) -> str:
        return f"Mesh({self.shape[DATA_AXIS]} data x {self.shape[SPATIAL_AXIS]} spatial: " \
               f"{[str(d) for d in self.devices.ravel()]})"


def cuda_devices() -> list:
    """Every visible CUDA device, in index order (none without CUDA)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    n_data: Optional[int] = None,
    n_spatial: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a (data, spatial) mesh. Defaults to all devices on the data axis.

    ``devices=None`` takes the visible CUDA devices (the first
    ``n_data * n_spatial`` of them) and raises if there are fewer; a given
    list may repeat a device (the rehearsal layout, see the module
    docstring)."""
    devices = [torch.device(d) for d in (devices if devices is not None else cuda_devices())]
    if n_data is None:
        if len(devices) % n_spatial != 0:
            raise ValueError(
                f"{len(devices)} devices not divisible by n_spatial={n_spatial}"
            )
        n_data = len(devices) // n_spatial
    n = n_data * n_spatial
    if n < 1 or len(devices) < n:
        raise ValueError(
            f"mesh ({n_data} data x {n_spatial} spatial) needs {max(n, 1)} devices, "
            f"but only {len(devices)} are available"
        )
    grid = np.empty((n_data, n_spatial), dtype=object)
    for i, d in enumerate(devices[:n]):
        grid[divmod(i, n_spatial)] = d
    return Mesh(grid)


def pad_to_multiple(batch: np.ndarray, multiple: int):
    """Pad the batch axis up to a multiple (repeat-edge); returns (arr, n_real)."""
    n = batch.shape[0]
    if n % multiple == 0:
        return batch, n
    pad = multiple - n % multiple
    reps = np.repeat(batch[-1:], pad, axis=0)
    return np.concatenate([batch, reps], axis=0), n
