"""Training engine: WaterNet trained from the host or from a device cache.

The port of the JAX package's ``training/trainer.py``. Two ways to feed a
step, the same step either way:

* **host-fed** (the reference's default): :meth:`TrainingEngine.
  train_epoch` over a batch iterator, or :meth:`TrainingEngine.
  train_epoch_pipelined`, where an :class:`~waternet_tpu_torch.data.
  pipeline.OrderedPipeline` of worker threads loads batch k+1, (with
  ``host_preprocess``) runs cv2's WB/GC/CLAHE on it, and copies it to the
  device (:class:`~waternet_tpu_torch.utils.tensor.DeviceFeeder`) while
  step k runs. The pipelined epoch equals the synchronous one bit for
  bit; its metrics carry the ``pipeline_*`` keys.
* **device cache**: ``cache_dataset`` pins the dataset on the device
  under a codec (``raw``, ``yuv420`` or ``dct8``, :mod:`waternet_tpu_torch.
  data.codec`); every step gathers its batch by index there and decodes
  it there. The host sends indices only. With the raw codec and
  ``precache_histeq`` (the default) the cache build also computes WB and
  GC of every item and CLAHE of each of its dihedral variants (the CLAHE
  kernels, one launch per chunk of items), so the steady-state step
  (:meth:`TrainingEngine.train_step_cached_pre`) gathers those and runs
  no classical transform; ``precache_vgg_ref`` adds VGG19's relu5_4
  features of every reference variant, so the perceptual term runs no
  VGG forward on the reference either.

By default (device preprocessing) a step gets uint8 (raw, ref) batches
and runs augment, WB/GC/CLAHE (the CLAHE kernels), the WaterNet forward
and backward, MSE plus the VGG19 perceptual loss, and Adam under the
reference's staircase schedule; its augmentation comes from
:func:`step_generator` (seed, epoch, batch), so a batch gives the same
step whether it came from the host or from the raw cache. With
``host_preprocess`` the step gets the five float32 views made on the
host (``train_step_pre``), augmented by numpy draws from
``default_rng(seed + 7 + epoch)``, as in the JAX package. Metrics are
read back once per epoch.

Optimization, as the reference and the JAX package: Adam, lr 1e-3 (the
betas and eps of ``optax.adam``), times 0.1 every ``lr_step`` minibatches
(staircase), the loss ``0.05 * perceptual + mse_255``. Only WaterNet's
parameters train: VGG19 is frozen and holds no optimizer state.

``precision="bf16"`` runs the model and VGG under ``torch.autocast`` with
bfloat16 while the parameters stay float32, as the JAX package's Flax
modules with ``dtype=bf16`` do.

The train step takes an optional ``stamp`` callable, called with each
stage's name as the stage's work has been enqueued (gather_decode,
preprocess, forward, losses, backward, optimizer, metrics);
``stage_profile --train`` records a CUDA event there. By default it does
nothing.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item rather than being ignored): spatial sharding and distillation.
Mid-epoch resume and the resilience controls of the JAX epochs
(``start_batch``, ``carry``, ``control``) are not ported either.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Optional

import numpy as np
import torch

from waternet_tpu_torch.data import codec as cachecodec
from waternet_tpu_torch.data.augment import (
    advance_augment_rng,
    apply_augment_batch,
    augment_pair_np,
    dihedral_apply,
    dihedral_variant_count,
    dihedral_variant_index,
    draw_augment,
)
from waternet_tpu_torch.data.batching import epoch_permutation
from waternet_tpu_torch.data.pipeline import OrderedPipeline, PipelineStats
from waternet_tpu_torch.models import WaterNet
from waternet_tpu_torch.models.vgg import VGG19Features, imagenet_normalize, init_vgg_params
from waternet_tpu_torch.ops.clahe import histeq
from waternet_tpu_torch.ops.fused import fused_train_preprocess
from waternet_tpu_torch.ops.gamma import gamma_correction
from waternet_tpu_torch.ops.transform import transform_np
from waternet_tpu_torch.ops.wb import white_balance
from waternet_tpu_torch.training.losses import PERCEPTUAL_WEIGHT, mse_255, perceptual_loss
from waternet_tpu_torch.training.metrics import psnr as psnr_fn
from waternet_tpu_torch.training.metrics import ssim as ssim_fn
from waternet_tpu_torch.utils.convert import state_dict_from_jax, vgg_state_dict_from_jax
from waternet_tpu_torch.utils.device import resolve_device
from waternet_tpu_torch.utils.tensor import DeviceFeeder, to_device

TRAIN_METRICS_NAMES = ["mse", "ssim", "psnr", "perceptual_loss", "loss"]
VAL_METRICS_NAMES = ["mse", "ssim", "psnr", "perceptual_loss"]


@dataclasses.dataclass
class TrainConfig:
    """The JAX package's ``TrainConfig``: the same fields and defaults."""

    epochs: int = 400
    batch_size: int = 16
    im_height: int = 112
    im_width: int = 112
    lr: float = 1e-3
    lr_step: int = 10000  # minibatches, the reference's train.py:251
    lr_gamma: float = 0.1
    perceptual_weight: float = PERCEPTUAL_WEIGHT
    precision: str = "bf16"  # model/VGG compute dtype; params stay fp32
    shuffle: bool = True
    seed: int = 0
    augment: bool = True
    host_preprocess: bool = False
    spatial_shards: int = 1
    # Precompute WB/GC and the dihedral CLAHE table at cache build (raw
    # codec only; lossy codecs ignore it, as in the JAX package). Bit-exact:
    # WB and gamma commute with every flip/rot90 (global statistics are
    # permutation-invariant, gamma is pointwise), and CLAHE, which does not
    # commute, is stored for each of the 8 (square; 4 non-square) canonical
    # augmentations and selected per image by the step's own draws.
    precache_histeq: bool = True
    # Also precompute VGG19's relu5_4 features of every reference variant
    # (the reference branch carries no gradient). Requires precache_histeq,
    # device preprocessing and the perceptual term.
    precache_vgg_ref: bool = False
    distill: bool = False
    student_width: int = 24
    student_depth: int = 7
    cache_codec: str = "raw"

    def check_ported(self) -> None:
        """Raise ``NotImplementedError`` for a field whose path the port
        does not have yet, naming its ROADMAP item."""
        missing = {
            "spatial_shards > 1": (self.spatial_shards > 1, "Queue A item 8 (multi-GPU)"),
            "distill": (self.distill, "Queue A item 7 (fast tier)"),
        }
        for name, (on, item) in missing.items():
            if on:
                raise NotImplementedError(
                    f"TrainConfig.{name} is not ported to waternet_tpu_torch yet "
                    f"(ROADMAP {item})"
                )
        if self.precision not in ("bf16", "fp32"):
            raise ValueError(f"precision must be 'bf16' or 'fp32', got {self.precision!r}")


def make_optimizer(params, config: TrainConfig):
    """(Adam, its schedule): lr ``config.lr * lr_gamma ** (step // lr_step)``
    (optax's staircase ``exponential_decay``); the schedule is stepped once
    per train step."""
    opt = torch.optim.Adam(params, lr=config.lr, betas=(0.9, 0.999), eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: config.lr_gamma ** (step // config.lr_step)
    )
    return opt, sched


def step_generator(seed: int, epoch: int, batch: int) -> torch.Generator:
    """The augmentation generator of one train step: a CPU generator seeded
    from (seed + 1, epoch, batch index), as the JAX trainer folds its key,
    so the CPU and CUDA ports draw the same augmentations."""
    state = np.random.SeedSequence([seed + 1, epoch, batch]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state) >> 1)


def _no_stamp(stage: str) -> None:
    """The steps' default ``stamp``: nothing."""


def vgg_ref_bytes_per_item(h: int, w: int, precision: str) -> int:
    """Bytes of one VGG19 relu5_4 feature map (H/16 x W/16 x 512) in the
    compute dtype: what precache_vgg_ref pins per item and variant."""
    return (h // 16) * (w // 16) * 512 * (2 if precision == "bf16" else 4)


@torch.no_grad()
def transform_tables(raw_u8: torch.Tensor, n_var: int, chunk: int):
    """The precache tables of an (N, H, W, 3) uint8 tensor, built on its
    device: ``(wb, gc, he)``, uint8, ``wb``/``gc`` (N, H, W, 3) and ``he``
    (n_var, N, H, W, 3) with ``he[v, i]`` = histeq of item i under dihedral
    variant v (``n_var=1``: the identity only, for eval).

    Works in chunks of ``chunk`` items; each chunk's variants are stacked
    on the batch axis into one ``histeq`` call, so one launch of each CLAHE
    kernel covers ``n_var * chunk`` images. The transforms get float32
    inputs, as in the step, and return exact uint8 values, so the uint8
    tables lose nothing."""
    n, h, w, c = raw_u8.shape
    square = h == w
    wb = torch.empty_like(raw_u8)
    gc = torch.empty_like(raw_u8)
    he = torch.empty((n_var, n, h, w, c), dtype=torch.uint8, device=raw_u8.device)
    for start in range(0, n, chunk):
        part = raw_u8[start : start + chunk].to(torch.float32)
        stop = start + part.shape[0]
        wb[start:stop] = white_balance(part).to(torch.uint8)
        gc[start:stop] = gamma_correction(part).to(torch.uint8)
        stacked = torch.cat([dihedral_apply(part, v, square) for v in range(n_var)])
        he[:, start:stop] = histeq(stacked).to(torch.uint8).reshape(n_var, -1, h, w, c)
    return wb, gc, he


def _waternet_state_dict(params) -> dict:
    if "cmg.conv1.weight" in params:
        return {k: torch.as_tensor(v) for k, v in params.items()}
    return state_dict_from_jax(params)


def _vgg_state_dict(params) -> dict:
    if "features.0.weight" in params:
        return {k: torch.as_tensor(v) for k, v in params.items()}
    return vgg_state_dict_from_jax(params)


class TrainingEngine:
    def __init__(
        self,
        config: TrainConfig,
        params: Optional[dict] = None,
        vgg_params: Optional[dict] = None,
        device="cuda",
    ):
        """``params``: WaterNet weights as the JAX tree (nested or flat
        keys; converted) or as a port state_dict; None draws the port's own
        init under ``torch.manual_seed(config.seed)``. ``vgg_params``
        likewise (JAX tree or ``features.*`` state_dict); None with the
        perceptual term on takes the deterministic random init."""
        config.check_ported()
        self.config = config
        self.device = resolve_device(device)
        if params is None:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(config.seed)
                sd = WaterNet().state_dict()
        else:
            sd = _waternet_state_dict(params)
        self.model = WaterNet()
        self.model.load_state_dict(sd, strict=True)
        self.model.to(self.device).train()

        self.vgg = None
        if config.perceptual_weight != 0.0:
            vsd = init_vgg_params() if vgg_params is None else _vgg_state_dict(vgg_params)
            self.vgg = VGG19Features()
            self.vgg.load_state_dict(vsd, strict=True)
            self.vgg.to(self.device).eval().requires_grad_(False)

        self.optimizer, self.scheduler = make_optimizer(self.model.parameters(), config)
        self._feeder = DeviceFeeder(self.device)
        self._cache_enc = None
        self._cache_pre = None
        self._val_cache = None

    # ------------------------------------------------------------------
    # Steps
    # ------------------------------------------------------------------

    def _autocast(self):
        if self.config.precision != "bf16":
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, dtype=torch.bfloat16)

    def _losses_and_out(self, x, wbn, hen, gcn, refn, mask, stamp=_no_stamp, ref_feats=None):
        with self._autocast():
            out = self.model(x, wbn, hen, gcn)
        out = out.to(torch.float32)
        stamp("forward")
        mse = mse_255(out, refn, mask)
        aux = {"mse": mse, "perceptual_loss": torch.zeros((), device=self.device)}
        loss = mse
        if self.config.perceptual_weight != 0.0:
            with self._autocast():
                perc = perceptual_loss(self.vgg, out, refn, mask, ref_feats=ref_feats)
            aux["perceptual_loss"] = perc
            loss = self.config.perceptual_weight * perc + mse
        stamp("losses")
        return loss, out, aux

    @torch.no_grad()
    def _metrics(self, out, refn, aux, mask, loss=None) -> dict:
        m = {
            "mse": aux["mse"].detach(),
            "ssim": ssim_fn(out, refn, mask=mask),
            "psnr": psnr_fn(out, refn, data_range=1.0, mask=mask),
            "perceptual_loss": aux["perceptual_loss"].detach(),
        }
        if loss is not None:
            m["loss"] = loss.detach()
        return m

    def _mask(self, n: int, n_real: int) -> torch.Tensor:
        return torch.arange(n, device=self.device) < n_real

    def train_step(self, raw_u8, ref_u8, generator, n_real: int, stamp=_no_stamp) -> dict:
        """One optimizer step on a uint8 (N, H, W, 3) pair batch on the
        engine's device; returns the step's metrics as 0-d device tensors
        (nothing is read back)."""
        with torch.no_grad():
            views = fused_train_preprocess(raw_u8, ref_u8, generator, augment=self.config.augment)
        stamp("preprocess")
        return self.train_step_pre(*views, n_real, stamp=stamp)

    def train_step_pre(self, x, wbn, hen, gcn, refn, n_real: int, stamp=_no_stamp, ref_feats=None) -> dict:
        """One optimizer step on the five float32 [0, 1] views, in the
        network's input order; no transform runs inside it. ``ref_feats``
        (precache_vgg_ref) stands in for VGG's features of ``refn``."""
        mask = self._mask(x.shape[0], n_real)
        loss, out, aux = self._losses_and_out(x, wbn, hen, gcn, refn, mask, stamp, ref_feats)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        stamp("backward")
        self.optimizer.step()
        self.scheduler.step()
        stamp("optimizer")
        m = self._metrics(out.detach(), refn, aux, mask, loss)
        stamp("metrics")
        return m

    @torch.no_grad()
    def eval_step(self, raw_u8, ref_u8, n_real: int) -> dict:
        return self.eval_step_pre(*fused_train_preprocess(raw_u8, ref_u8, None), n_real)

    @torch.no_grad()
    def eval_step_pre(self, x, wbn, hen, gcn, refn, n_real: int, ref_feats=None) -> dict:
        mask = self._mask(x.shape[0], n_real)
        _, out, aux = self._losses_and_out(x, wbn, hen, gcn, refn, mask, ref_feats=ref_feats)
        return self._metrics(out, refn, aux, mask)

    # ------------------------------------------------------------------
    # The device cache
    # ------------------------------------------------------------------

    def _precaching(self) -> bool:
        return self.config.precache_histeq and not self.config.host_preprocess

    def _preflight_cache_budget(self, n_items: int) -> str:
        """Size the cache, its precache tables included, against the
        device's headroom before anything is pinned; resolve ``auto`` to a
        codec (written back into the config, as the JAX trainer does).
        Raises ``CacheBudgetError``."""
        h, w = self.config.im_height, self.config.im_width
        row = cachecodec.choose_codec(
            self.config.cache_codec, n_items, h, w,
            headroom=cachecodec.resolve_headroom(self.device),
            precache_histeq=self._precaching(),
            precache_vgg_ref=self.config.precache_vgg_ref,
            vgg_ref_bytes_per_item=vgg_ref_bytes_per_item(h, w, self.config.precision),
        )
        self.config.cache_codec = row["codec"]
        return row["codec"]

    def _pin_pairs(self, dataset, indices, codec: str) -> dict:
        """Encode (raw, ref) under ``codec`` on the host and pin each plane
        on the device as one (2, N, ...) tensor: raw at 0, ref at 1, so a
        batch of both is one gather."""
        pairs = [dataset.load_pair(int(i)) for i in indices]
        raw = cachecodec.encode(codec, np.stack([p[0] for p in pairs]))
        ref = cachecodec.encode(codec, np.stack([p[1] for p in pairs]))
        return {k: torch.from_numpy(np.stack([raw[k], ref[k]])).to(self.device) for k in raw}

    def cache_dataset(self, dataset, indices) -> None:
        """Pin the (raw, ref) pairs of ``indices`` on the device under
        ``config.cache_codec``, after the preflight budgeter (which resolves
        ``auto``). Lossy codecs pin the encoded planes; each step decodes
        only its batch. The raw codec with ``precache_histeq`` also builds
        the precache tables on the device (and, with ``precache_vgg_ref``,
        the VGG feature table); the JAX package's rules and messages."""
        cfg = self.config
        if cfg.host_preprocess:
            raise ValueError("the device cache requires device preprocessing (host_preprocess=False)")
        if cfg.precache_vgg_ref:
            if cfg.cache_codec != "raw":
                # Built over decoded pixels, the table would outgrow the raw
                # cache and defeat the codec.
                raise ValueError(
                    "precache_vgg_ref requires cache_codec='raw': the feature table is "
                    "precomputed from the raw-resident ref and would defeat a compressed cache"
                )
            if not (cfg.precache_histeq and cfg.perceptual_weight != 0.0):
                # It rides the CLAHE table's variant index, and precaches a
                # term that must be in the loss: an ignored flag would let an
                # A/B run measure nothing.
                raise ValueError(
                    "precache_vgg_ref requires precache_histeq=True, host_preprocess=False, "
                    "and a nonzero perceptual_weight"
                )
        codec = self._preflight_cache_budget(len(indices))
        self._cache_enc = self._cache_pre = None  # free the old cache before pinning the new
        self._cache_enc = self._pin_pairs(dataset, indices, codec)
        self._cache_len = len(indices)
        if codec == "raw" and self._precaching():
            h, w = self._cache_enc["raw"].shape[2:4]
            self._cache_pre = self._pre_tables(self._cache_enc["raw"], dihedral_variant_count(h, w))

    def _pre_tables(self, pair: torch.Tensor, n_var: int) -> dict:
        """The precache tables of a pinned (2, N, H, W, 3) raw pair tensor,
        with ``n_var`` variants (1 for eval); what the cached-pre steps
        take. ``vgg_ref`` is None without precache_vgg_ref."""
        chunk = min(pair.shape[1], max(1, self.config.batch_size))
        wb, gc, he = transform_tables(pair[0], n_var, chunk)
        vgg_ref = None
        if self.config.precache_vgg_ref and self.vgg is not None:
            vgg_ref = self._vgg_ref_table(pair[1], n_var, chunk)
        return {"pair": pair, "wb": wb, "gc": gc, "he": he, "vgg_ref": vgg_ref}

    @torch.no_grad()
    def _vgg_ref_table(self, ref_u8: torch.Tensor, n_var: int, chunk: int) -> torch.Tensor:
        """[variant, item] VGG19 relu5_4 features of an (N, H, W, 3) uint8
        reference tensor, under the engine's autocast, stored in the
        compute dtype (the forward's values, so nothing is lost). VGG runs
        on pieces of the step's batch size: at the step's shapes cuDNN picks
        the step's algorithms, so a full batch's features are the in-step
        ones (another batch composition rounds them differently)."""
        n, h, w, _ = ref_u8.shape
        table = None
        for start in range(0, n, chunk):
            part = ref_u8[start : start + chunk].to(torch.float32) / 255.0
            stacked = torch.cat([dihedral_apply(part, v, h == w) for v in range(n_var)])
            with self._autocast():
                feats = torch.cat([self.vgg(imagenet_normalize(piece))
                                   for piece in stacked.split(self.config.batch_size)])
            dtype = torch.bfloat16 if self.config.precision == "bf16" else torch.float32
            feats = feats.to(dtype).reshape(n_var, part.shape[0], *feats.shape[1:])
            if table is None:
                table = torch.empty((n_var, n, *feats.shape[2:]), dtype=feats.dtype, device=feats.device)
            table[:, start : start + part.shape[0]] = feats
        return table

    def cache_resident_bytes(self) -> Optional[int]:
        """Bytes pinned by the training cache, its precache tables included,
        or None without one."""
        if self._cache_enc is None:
            return None
        tensors = list(self._cache_enc.values())
        if self._cache_pre is not None:
            tensors += [self._cache_pre[k] for k in ("wb", "gc", "he", "vgg_ref")]
        return sum(t.numel() * t.element_size() for t in tensors if t is not None)

    def _gather_decode(self, enc: dict, codec: str, idx: torch.Tensor):
        """Gather the batch ``idx`` of raw and ref from a pinned cache and
        decode both in one call (one dct8 kernel launch): two uint8
        (B, H, W, 3) tensors."""
        b = idx.shape[0]
        payload = {
            k: v.index_select(1, idx).reshape(2 * b, *v.shape[2:]) for k, v in enc.items()
        }
        pix = cachecodec.decode(codec, payload, self.config.im_height, self.config.im_width)
        return pix[:b], pix[b:]

    def _cached_index_batches(self, n: int, epoch: int, shuffle: bool):
        """Yield (idx, n_real) covering all n items: the JAX trainer's batch
        composition (the same Philox shuffle), without its padding to the
        data axis (the port runs on one device)."""
        order = epoch_permutation(np.arange(n), self.config.seed, epoch) if shuffle else np.arange(n)
        for start in range(0, n, self.config.batch_size):
            idx = order[start : start + self.config.batch_size].astype(np.int64)
            yield to_device(torch.from_numpy(idx), self.device), len(idx)

    def cached_train_step(self):
        """(step_fn, cache_args) for the current cache: callers append
        ``(idx, generator, n_real)``. The one dispatch point of the cached
        step, which train_epoch_cached and benchmarks share: the cached-pre
        step when the precache tables exist, the codec step otherwise."""
        if self._cache_enc is None:
            raise RuntimeError("call cache_dataset() before cached_train_step()")
        if self._cache_pre is not None:
            return self.train_step_cached_pre, (self._cache_pre,)
        return self.train_step_cached_codec, (self._cache_enc,)

    def train_step_cached_codec(self, enc, idx, generator, n_real, stamp=_no_stamp):
        raw_u8, ref_u8 = self._gather_decode(enc, self.config.cache_codec, idx)
        stamp("gather_decode")
        return self.train_step(raw_u8, ref_u8, generator, n_real, stamp)

    @staticmethod
    def _gather_pre(cache: dict, idx: torch.Tensor):
        """raw, ref, wb and gc of the batch ``idx`` from precache tables,
        as float32 uint8 values."""
        pair = cache["pair"].index_select(1, idx).to(torch.float32)
        return (pair[0], pair[1], *(cache[k].index_select(0, idx).to(torch.float32) for k in ("wb", "gc")))

    def train_step_cached_pre(self, cache, idx, generator, n_real, stamp=_no_stamp):
        """The cached step with the transforms hoisted out (the JAX
        trainer's ``_cached_pre_body``): gather raw, ref, WB and GC, augment
        all four with the draws ``fused_train_preprocess`` would make (one
        ``draw_augment``), then gather each image's CLAHE (and, with
        precache_vgg_ref, its reference features) from the table row of its
        dihedral variant. No classical transform runs; the step equals the
        in-step raw-cache step bit for bit."""
        raw, ref, wb, gc = self._gather_pre(cache, idx)
        stamp("gather_decode")
        if self.config.augment and generator is not None:
            square = self.config.im_height == self.config.im_width
            hflip, vflip, rotk = draw_augment(generator, idx.shape[0])
            variant = dihedral_variant_index(hflip, vflip, rotk, square)
            # One copy to the device for all the draws.
            draws = to_device(torch.stack([t.to(torch.int64) for t in (hflip, vflip, rotk, variant)]), self.device)
            hflip, vflip, rotk, variant = draws[0].bool(), draws[1].bool(), draws[2], draws[3]
            raw, ref, wb, gc = (apply_augment_batch(t, hflip, vflip, rotk) for t in (raw, ref, wb, gc))
        else:
            variant = torch.zeros_like(idx)
        he = cache["he"][variant, idx].to(torch.float32)
        ref_feats = None if cache["vgg_ref"] is None else cache["vgg_ref"][variant, idx]
        stamp("preprocess")
        return self.train_step_pre(raw / 255.0, wb / 255.0, he / 255.0, gc / 255.0, ref / 255.0,
                                   n_real, stamp=stamp, ref_feats=ref_feats)

    @torch.no_grad()
    def eval_step_cached_pre(self, cache, idx, n_real):
        """Eval over precache tables: no augmentation, so every image reads
        the identity variant's row 0."""
        raw, ref, wb, gc = self._gather_pre(cache, idx)
        he = cache["he"][0].index_select(0, idx).to(torch.float32)
        ref_feats = None if cache["vgg_ref"] is None else cache["vgg_ref"][0].index_select(0, idx)
        return self.eval_step_pre(raw / 255.0, wb / 255.0, he / 255.0, gc / 255.0, ref / 255.0,
                                  n_real, ref_feats=ref_feats)

    @staticmethod
    def _epoch_means(per_step: list, names) -> dict:
        """Mean of the per-step metrics, read back from the device once."""
        if not per_step:
            return {k: 0.0 for k in names}
        stacked = torch.stack([torch.stack([m[k].float() for k in names]) for m in per_step])
        means = stacked.mean(dim=0).cpu().tolist()
        return dict(zip(names, means))

    def train_epoch_cached(self, epoch: int) -> dict:
        """One epoch over the cached dataset; the mean of the per-step
        metrics, read back once at the epoch's end."""
        step_fn, cache_args = self.cached_train_step()
        self.model.train()
        per_step = []
        for count, (idx, n_real) in enumerate(
            self._cached_index_batches(self._cache_len, epoch, self.config.shuffle)
        ):
            gen = step_generator(self.config.seed, epoch, count)
            per_step.append(step_fn(*cache_args, idx, gen, n_real))
        return self._epoch_means(per_step, TRAIN_METRICS_NAMES)

    def eval_epoch_cached(self, dataset=None, indices=None) -> dict:
        """Eval over a device cache. With ``dataset``/``indices``: a val
        cache of exactly those pairs, always raw (kept until another dataset
        or index set is asked for), with identity-variant precache tables
        when ``precache_histeq`` is on (built with the val cache, whatever
        the train cache's codec, as in the JAX trainer), else WB/GC/CLAHE
        in the step. With ``dataset=None``: the train cache, through its
        own tables' variant 0 or decoded in the step."""
        if dataset is not None:
            ids = tuple(int(i) for i in indices)
            cached = self._val_cache
            if cached is None or cached[0] is not dataset or cached[1] != ids:
                self._val_cache = None
                enc = self._pin_pairs(dataset, ids, "raw")
                pre = self._pre_tables(enc["raw"], 1) if self._precaching() else None
                self._val_cache = (dataset, ids, enc, pre)
            enc, pre, codec, n = self._val_cache[2], self._val_cache[3], "raw", len(ids)
        else:
            if self._cache_enc is None:
                raise RuntimeError("no cached dataset for eval_epoch_cached()")
            enc, pre, codec, n = self._cache_enc, self._cache_pre, self.config.cache_codec, self._cache_len
        self.model.eval()
        per_step = [
            self.eval_step_cached_pre(pre, idx, n_real) if pre is not None
            else self.eval_step(*self._gather_decode(enc, codec, idx), n_real)
            for idx, n_real in self._cached_index_batches(n, epoch=0, shuffle=False)
        ]
        self.model.train()
        return self._epoch_means(per_step, VAL_METRICS_NAMES)

    # ------------------------------------------------------------------
    # Host-fed epochs
    # ------------------------------------------------------------------

    def _host_preprocess_np(self, raw, ref, rng_np=None):
        """The host-preprocess path's host stage: the optional paired
        augment, then cv2's WB/GC/CLAHE per image, returned as the five
        float32 numpy views ``(x, wb, he, gc, ref)`` scaled to [0, 1]."""
        if rng_np is not None and self.config.augment:
            raw, ref = augment_pair_np(rng_np, raw, ref)
        wbs, gcs, hes = zip(*(transform_np(f) for f in raw))
        as_f = lambda arrs: np.stack(list(arrs)).astype(np.float32) / 255.0  # noqa: E731
        return as_f(raw), as_f(wbs), as_f(hes), as_f(gcs), as_f(ref)

    def _train_on(self, epoch: int, count: int, tensors, n_real: int) -> dict:
        """One train step on a batch already on the device: the five views
        (host preprocessing) or the uint8 (raw, ref) pair, augmented by the
        step's own generator as in ``train_epoch_cached``."""
        if self.config.host_preprocess:
            return self.train_step_pre(*tensors, n_real)
        return self.train_step(*tensors, step_generator(self.config.seed, epoch, count), n_real)

    def _eval_on(self, tensors, n_real: int) -> dict:
        if self.config.host_preprocess:
            return self.eval_step_pre(*tensors, n_real)
        return self.eval_step(*tensors, n_real)

    def _feed(self, arrays):
        """Host arrays -> device tensors, on the consumer's thread."""
        return self._feeder.receive(self._feeder.send(arrays))

    def train_epoch(self, batch_iter, epoch: int) -> dict:
        """One synchronous host-fed epoch over ``(raw_u8, ref_u8)`` numpy
        batches; the mean of the per-step metrics, read back once. With
        ``host_preprocess`` the batches are augmented from one numpy
        stream, ``default_rng(seed + 7 + epoch)``, batch after batch."""
        host_rng = np.random.default_rng(self.config.seed + 7 + epoch)
        self.model.train()
        per_step = []
        for count, (raw, ref) in enumerate(batch_iter):
            arrays = self._host_preprocess_np(raw, ref, host_rng) if self.config.host_preprocess else (raw, ref)
            per_step.append(self._train_on(epoch, count, self._feed(arrays), raw.shape[0]))
        return self._epoch_means(per_step, TRAIN_METRICS_NAMES)

    def eval_epoch(self, batch_iter) -> dict:
        """Synchronous host-fed eval over ``(raw_u8, ref_u8)`` numpy batches
        (no augmentation)."""
        self.model.eval()
        per_step = []
        for raw, ref in batch_iter:
            arrays = self._host_preprocess_np(raw, ref) if self.config.host_preprocess else (raw, ref)
            per_step.append(self._eval_on(self._feed(arrays), raw.shape[0]))
        self.model.train()
        return self._epoch_means(per_step, VAL_METRICS_NAMES)

    def _epoch_plan(self, indices, epoch: int, shuffle: bool):
        """``[(count, index_chunk)]`` for one epoch: the batches of
        :func:`~waternet_tpu_torch.data.batching.iter_batches` (same Philox
        stream) as a work list whose items workers may produce in any
        order."""
        order = epoch_permutation(indices, self.config.seed, epoch) if shuffle else np.array(indices, copy=True)
        b = self.config.batch_size
        return [(count, order[s : s + b]) for count, s in enumerate(range(0, len(order), b))]

    def _plan_augment_states(self, plan, epoch: int):
        """Each batch's start state of the host augment stream, or None when
        the stream is unused. The consumer advances the one stream the
        synchronous epoch draws from, without data, and records where each
        batch starts; a worker clones its batch's state and makes the same
        draws in any completion order. The port runs on one device, so a
        batch of n items consumes n items' draws (no padding rows)."""
        if not (self.config.host_preprocess and self.config.augment):
            return None
        host_rng = np.random.default_rng(self.config.seed + 7 + epoch)
        states = {}
        for count, chunk in plan:
            states[count] = copy.deepcopy(host_rng.bit_generator.state)
            advance_augment_rng(host_rng, len(chunk))
        return states

    def _pipeline_produce(self, dataset, aug_states, stats: PipelineStats):
        """The worker function for one ``(count, chunk)`` work item: load
        the pairs, (host preprocessing) run the host stage with the batch's
        own cloned RNG, and copy the result to the device, each stage timed
        into ``stats``. A pure function of the item, so completion order
        cannot change results. Returns ``(count, sent, n_real)``; the
        consumer keeps no batch past its step, only its 0-d metrics."""

        def produce(item):
            count, chunk = item
            with stats.stage("load"):
                pairs = [dataset.load_pair(int(i)) for i in chunk]
                raw = np.stack([p[0] for p in pairs])
                ref = np.stack([p[1] for p in pairs])
            arrays = (raw, ref)
            if self.config.host_preprocess:
                rng_np = None
                if aug_states is not None:
                    rng_np = np.random.default_rng(0)
                    rng_np.bit_generator.state = copy.deepcopy(aug_states[count])
                with stats.stage("preprocess"):
                    arrays = self._host_preprocess_np(raw, ref, rng_np)
            with stats.stage("transfer"):
                sent = self._feeder.send(arrays)
            stats.add_transfer_bytes(sum(a.nbytes for a in arrays))
            return count, sent, len(chunk)

        return produce

    def _run_pipeline(self, dataset, plan, aug_states, step, workers: int, prefetch: int, name: str):
        """Drive ``step(count, tensors, n_real)`` over ``plan`` through an
        :class:`OrderedPipeline`; -> (per-step metrics, stats). The
        ``step`` stage times the step's enqueue on the consumer thread."""
        stats = PipelineStats()
        per_step = []
        produce = self._pipeline_produce(dataset, aug_states, stats)
        with OrderedPipeline(produce, plan, workers=workers, prefetch=prefetch, stats=stats, name=name) as pipe:
            for count, sent, n_real in pipe:
                with stats.stage("step"):
                    per_step.append(step(count, self._feeder.receive(sent), n_real))
        return per_step, stats

    def train_epoch_pipelined(self, dataset, indices, epoch: int, *, workers: int = 2, prefetch: int = 0) -> dict:
        """Overlapped host-fed epoch: equal, bit for bit, to
        :meth:`train_epoch` over ``dataset.batches(indices, ...)`` (same
        batches, same augment draws, same steps), with loading, host
        preprocessing and the copy to the device of later batches running
        on ``workers`` threads while the current step runs. ``workers=0``
        runs the same code inline. The metrics gain the ``pipeline_*``
        keys: stall pct, per-stage ms, queue depth, workers, and the
        transfer bytes per batch."""
        plan = self._epoch_plan(indices, epoch, self.config.shuffle)
        aug_states = self._plan_augment_states(plan, epoch)
        self.model.train()
        per_step, stats = self._run_pipeline(
            dataset, plan, aug_states,
            lambda count, tensors, n_real: self._train_on(epoch, count, tensors, n_real),
            workers, prefetch, "train",
        )
        out = self._epoch_means(per_step, TRAIN_METRICS_NAMES)
        out.update(stats.metrics())
        return out

    def eval_epoch_pipelined(self, dataset, indices, *, workers: int = 2, prefetch: int = 0) -> dict:
        """Pipelined counterpart of :meth:`eval_epoch` (no shuffle, no
        augmentation): the same metric values, plus the ``pipeline_*`` keys."""
        plan = self._epoch_plan(indices, epoch=0, shuffle=False)
        self.model.eval()
        per_step, stats = self._run_pipeline(
            dataset, plan, None, lambda count, tensors, n_real: self._eval_on(tensors, n_real),
            workers, prefetch, "eval",
        )
        self.model.train()
        out = self._epoch_means(per_step, VAL_METRICS_NAMES)
        out.update(stats.metrics())
        return out
