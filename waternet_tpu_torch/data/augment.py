"""Paired augmentation on the device: the reference's flips and rot90.

``HorizontalFlip(p=0.5)``, ``VerticalFlip(p=0.5)`` and
``RandomRotate90(p=0.5)`` (k uniform in {0, 1, 2, 3} when applied), the
same draws for the raw image and its reference, applied before the
WB/GC/CLAHE transforms, as in the JAX package (data/augment.py:27-121).
For a non-square batch a 90/270-degree rotation would change the shape,
so only k == 2 (180 degrees) is applied there.

The draws come from an explicit ``torch.Generator`` (the trainer's is a
CPU generator, so the CPU and CUDA ports draw alike); they differ from
``jax.random``'s by design. :func:`apply_augment_batch` applies given draws
exactly as the JAX package does, which the tests pin with shared draws.

The host-preprocess path augments on the host instead:
:func:`augment_pair_np` and :func:`advance_augment_rng` are the JAX
package's numpy functions, drawing from a ``np.random.Generator``, so both
packages draw alike there.

The precache tables of the device cache hold one CLAHE image per dihedral
variant: :func:`dihedral_variant_index` maps the draws to that variant and
:func:`dihedral_apply` makes it, as the JAX package's helpers do
(data/augment.py:124-180).
"""

from __future__ import annotations

import numpy as np
import torch

from waternet_tpu_torch.data.codec import dihedral_variant_count  # noqa: F401
from waternet_tpu_torch.utils.tensor import to_device


def draw_augment(generator: torch.Generator, n: int):
    """Per-image draws ``(hflip, vflip, rotk)`` on the generator's device:
    two (n,) bool tensors and an (n,) int32 tensor in {0, 1, 2, 3}."""
    dev = generator.device
    hflip = torch.rand(n, generator=generator, device=dev) < 0.5
    vflip = torch.rand(n, generator=generator, device=dev) < 0.5
    do_rot = torch.rand(n, generator=generator, device=dev) < 0.5
    k = torch.randint(0, 4, (n,), generator=generator, device=dev)
    rotk = torch.where(do_rot, k, torch.zeros_like(k)).to(torch.int32)
    return hflip, vflip, rotk


def apply_augment_batch(imgs: torch.Tensor, hflip, vflip, rotk) -> torch.Tensor:
    """Apply per-image draws to an (N, H, W, C) batch -> float32,
    contiguous.

    Per image: hflip, then vflip, then ``rot90(k)`` over (H, W) (square),
    or 180 degrees iff k == 2 (non-square). Pure data movement, selected
    per image with ``torch.where``, so no value changes and nothing waits
    on the host. ``torch.where`` over the rot90 views would lay the batch
    out with H and W swapped in memory; the contiguous result gives
    cuDNN the same layout whatever the draws, so a convolution over it
    (VGG on the reference) rounds as over any other NHWC batch."""
    dev = imgs.device
    x = imgs.to(torch.float32)

    hflip, vflip, rotk = (to_device(t, dev) for t in (hflip, vflip, rotk))

    def pick(flag, a, b):
        return torch.where(flag.reshape(-1, 1, 1, 1), a, b)

    x = pick(hflip, x.flip(2), x)
    x = pick(vflip, x.flip(1), x)
    if x.shape[1] == x.shape[2]:
        out = x
        for k in (1, 2, 3):
            out = pick(rotk == k, torch.rot90(x, k, dims=(1, 2)), out)
        return out.contiguous()
    return pick(rotk == 2, torch.rot90(x, 2, dims=(1, 2)), x).contiguous()


def augment_pair_batch(generator: torch.Generator, raw: torch.Tensor, ref: torch.Tensor):
    """Paired flips/rot90 for an (N, H, W, C) batch: (raw_aug, ref_aug)
    float32, the same uint8 values rearranged."""
    hflip, vflip, rotk = draw_augment(generator, raw.shape[0])
    return (
        apply_augment_batch(raw, hflip, vflip, rotk),
        apply_augment_batch(ref, hflip, vflip, rotk),
    )


def augment_pair_np(rng: np.random.Generator, raw: np.ndarray, ref: np.ndarray):
    """Host (numpy) version of the same policy, for the host-preprocess
    path: (N, H, W, C) uint8 ``raw``/``ref`` -> augmented copies.

    Per image: hflip draw, vflip draw, rotate draw and, only when the
    rotate draw hits, one ``integers(0, 4)``; a non-square batch keeps
    k == 2 only, as the device path does."""
    raw = np.array(raw, copy=True)
    ref = np.array(ref, copy=True)
    square = raw.shape[1] == raw.shape[2]
    for i in range(raw.shape[0]):
        if rng.random() < 0.5:
            raw[i] = raw[i][:, ::-1]
            ref[i] = ref[i][:, ::-1]
        if rng.random() < 0.5:
            raw[i] = raw[i][::-1]
            ref[i] = ref[i][::-1]
        if rng.random() < 0.5:
            k = int(rng.integers(0, 4))
            if not square:
                k = 2 if k == 2 else 0
            raw[i] = np.rot90(raw[i], k, axes=(0, 1))
            ref[i] = np.rot90(ref[i], k, axes=(0, 1))
    return raw, ref


def advance_augment_rng(rng: np.random.Generator, n_items: int) -> None:
    """Advance a host augment stream past ``n_items`` images without data:
    :func:`augment_pair_np` consumes the generator in a data-independent
    pattern, so the pipeline can hand each batch its own start state."""
    for _ in range(n_items):
        rng.random()
        rng.random()
        if rng.random() < 0.5:
            rng.integers(0, 4)


# ---------------------------------------------------------------------------
# Dihedral decomposition of the (hflip, vflip, rotk) composite.
#
# The augment composite applied by apply_augment_batch is R^k . V^v . H^h
# (hflip first). Group identities (held exhaustively against
# apply_augment_batch by the tests):
#   square:      R^k . V^v . H^h  ==  R^{(k+2v)%4} . H^{(h+v)%2}
#   non-square (rot degraded to 180 iff k==2, with r := [k==2]):
#                ==  V^{(v+r)%2} . H^{(h+r)%2}
# so every reachable augmentation is one of 8 (square) / 4 (non-square)
# canonical variants. The precached-CLAHE path stores `histeq` of each
# canonical variant and selects by this index at step time: CLAHE does not
# commute with flips (tile interpolation has a half-pixel offset), so the
# variant table is how it is hoisted out of the step bit-exactly.
# ---------------------------------------------------------------------------


def dihedral_variant_index(hflip, vflip, rotk, square: bool):
    """Per-image canonical variant index for given draws, as an int64
    tensor (torch draws) or array (numpy draws).

    square:      refl*4 + rot with refl=(h+v)%2, rot=(k+2v)%4  (0..7)
    non-square:  hh*2 + vv   with r=[k==2], hh=(h+r)%2, vv=(v+r)%2 (0..3)
    """
    if isinstance(hflip, torch.Tensor):
        h, v, k = hflip.to(torch.int64), vflip.to(torch.int64), rotk.to(torch.int64)
    else:
        h, v, k = (np.asarray(a).astype(np.int64) for a in (hflip, vflip, rotk))
    if square:
        return (h + v) % 2 * 4 + (k + 2 * v) % 4
    r = (k == 2) * 1
    return (h + r) % 2 * 2 + (v + r) % 2


def dihedral_apply(imgs, variant: int, square: bool):
    """Apply canonical variant ``variant`` (a Python int) to an (N, H, W, C)
    tensor or numpy array: pure data movement, so no value changes."""
    if isinstance(imgs, torch.Tensor):
        hflip, vflip = (lambda x: x.flip(2)), (lambda x: x.flip(1))
        rot = lambda x, k: torch.rot90(x, k, dims=(1, 2))  # noqa: E731
    else:
        hflip, vflip = (lambda x: x[:, :, ::-1]), (lambda x: x[:, ::-1])
        rot = lambda x, k: np.rot90(x, k, axes=(1, 2))  # noqa: E731
    if square:
        refl, k = divmod(variant, 4)
        out = hflip(imgs) if refl else imgs
        return rot(out, k) if k else out
    hh, vv = divmod(variant, 2)
    out = hflip(imgs) if hh else imgs
    return vflip(out) if vv else out
