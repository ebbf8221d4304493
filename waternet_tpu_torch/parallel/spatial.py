"""Spatial sharding: the exact FCN forward with the image height split
across devices, halo rows copied between neighbours.

The port of the JAX package's ``parallel/spatial.py``. WaterNet has no
sequence dimension; its long-context analogue is spatial resolution. For
frames too large for one card (or to cut latency) the H axis is split
over the mesh's ``spatial`` axis and the whole network runs on
overlapping slabs.

Exactness, as in the JAX package:

* the network's receptive-field radius is **13 rows** (the confidence-map
  trunk's 7/5/3/1/7/5/3/3 kernels: 3+2+1+0+3+2+1+1); the refiners need 6
  and the gated fusion is pointwise;
* interior slab boundaries: 13 rows of true neighbour data make every kept
  output row equal to the unsharded forward's;
* true image edges: SAME convolution pads every *layer's* input with zeros,
  so 13 zero rows fed to an edge shard would not be equivalent (conv(0) +
  bias passes the ReLU). Each shard therefore runs on a window of true data
  whose outer boundary is the image edge for the edge shards: the layers'
  zero padding at the window's edge is then the unsharded model's.

Mechanics (K = 13, slab S = H / n_shards, S >= 2K): shard i holds its slab
on its device; each shard receives its neighbours' edge rows by a
device-to-device copy (one process, no collective, as the JAX package's
single-host ``shard_map``) and assembles ``[recv_top 2K | core S | recv_bot
2K]``; it takes the window of S + 2K rows starting at 2K (first shard:
global rows [0, S + 2K)), K (interior: [g - K, g + S + K)) or 0 (last:
[g - 2K, g + S)), runs the network on it, and crops ``2K - start`` ..
``+ S``. The rows a window never uses are not copied. The crops are
gathered to the first shard's device. Each device computes 26 rows more
than its slab.

Inputs and output are NHWC, as everywhere in the port, so H is dim 1 here
(dim 2 of the model's NCHW activations). Slicing, the copies between
devices and ``torch.cat`` are differentiable, so training runs its
forward and backward through this function (``training/trainer.py``).
cuDNN may pick another algorithm for a window than for the whole image,
so fp32 answers agree with the unsharded forward to float tolerance, not
bit for bit.
"""

from __future__ import annotations

from typing import Callable, Mapping, Union

import torch

from waternet_tpu_torch.parallel.mesh import SPATIAL_AXIS, Mesh

# Receptive-field radius of WaterNet (see module docstring).
HALO = 13

Forward = Callable[..., torch.Tensor]


def check_slab(h: int, n_shards: int) -> int:
    """The slab height of an H-row image over ``n_shards``; raises unless H
    divides evenly into slabs of at least ``2 * HALO`` rows."""
    if h % n_shards != 0:
        raise ValueError(f"image height {h} not divisible by spatial_shards={n_shards}")
    slab = h // n_shards
    if slab < 2 * HALO:
        raise ValueError(
            f"spatial slab of {slab} rows < 2*HALO={2 * HALO}; use fewer "
            f"spatial shards for this image height"
        )
    return slab


def spatial_sharded_apply(model: Union[Forward, Mapping[torch.device, Forward]], mesh: Mesh,
                          data_index: int = 0) -> Forward:
    """Build a forward running H-sharded over ``mesh``'s spatial axis.

    ``model`` is a callable ``model(x, wb, ce, gc) -> out`` on NHWC tensors
    with WaterNet's receptive field (a ``WaterNet`` module, a bf16
    ``run_model`` wrapper, or the int8 ``QuantWaterNet``, whose
    quantize/rescale steps are pointwise and so commute with the windows),
    used for every shard; or a mapping ``device -> callable`` giving each
    device of the spatial group its own replica (distinct cards).

    Returns ``fn(x, wb, ce, gc) -> out`` on full NHWC tensors; the result
    lies on the group's first device. The spatial axis size must divide H,
    and each slab must have at least ``2 * HALO`` rows.
    """
    devices = mesh.spatial_devices(data_index)
    n_shards = mesh.shape[SPATIAL_AXIS]
    k2 = 2 * HALO

    def replica(dev):
        return model[dev] if isinstance(model, Mapping) else model

    if n_shards == 1:
        fn = replica(devices[0])
        return lambda x, wb, ce, gc: fn(*(t.to(devices[0]) for t in (x, wb, ce, gc)))

    def windows(t: torch.Tensor, slab: int) -> list:
        """Each shard's window of ``t``: its slab, moved to its device,
        with the halo rows copied over from its neighbours' slabs."""
        cores = [t[:, i * slab:(i + 1) * slab].to(d) for i, d in enumerate(devices)]
        out = []
        for i, (core, d) in enumerate(zip(cores, devices)):
            if i == 0:  # start 2K: [core | recv_bot 2K]
                parts = [core, cores[1][:, :k2].to(d)]
            elif i == n_shards - 1:  # start 0: [recv_top 2K | core]
                parts = [cores[i - 1][:, -k2:].to(d), core]
            else:  # start K: [recv_top's last K | core | recv_bot's first K]
                parts = [cores[i - 1][:, -HALO:].to(d), core, cores[i + 1][:, :HALO].to(d)]
            out.append(torch.cat(parts, dim=1))
        return out

    def sharded(x, wb, ce, gc):
        slab = check_slab(x.shape[1], n_shards)
        per_input = [windows(t, slab) for t in (x, wb, ce, gc)]
        crops = []
        for i, d in enumerate(devices):
            start = k2 if i == 0 else (0 if i == n_shards - 1 else HALO)
            out = replica(d)(*(w[i] for w in per_input))
            lo = k2 - start
            crops.append(out[:, lo:lo + slab].to(devices[0]))
        return torch.cat(crops, dim=1)

    return sharded
