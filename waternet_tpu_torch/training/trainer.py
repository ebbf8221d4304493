"""Training engine: WaterNet trained from a dataset held on the device.

The port of the JAX package's ``training/trainer.py``, for its
device-cache path. ``cache_dataset`` pins the dataset on the device under
a codec (``raw``, ``yuv420`` or ``dct8``, :mod:`waternet_tpu_torch.data.
codec`); every step gathers its batch by index there, decodes it there,
and runs augment, WB/GC/CLAHE (the CLAHE kernels), the WaterNet forward
and backward, MSE plus the VGG19 perceptual loss, and Adam under the
reference's staircase schedule. The host sends indices only and reads
the metrics once per epoch.

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
item rather than being ignored): host-fed epochs and the input pipeline,
the precache tables (``precache_histeq`` with the raw codec,
``precache_vgg_ref``), ``host_preprocess``, spatial sharding, and
distillation.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch

from waternet_tpu_torch.data import codec as cachecodec
from waternet_tpu_torch.data.batching import epoch_permutation
from waternet_tpu_torch.models import WaterNet
from waternet_tpu_torch.models.vgg import VGG19Features, init_vgg_params
from waternet_tpu_torch.ops.fused import fused_train_preprocess
from waternet_tpu_torch.training.losses import PERCEPTUAL_WEIGHT, mse_255, perceptual_loss
from waternet_tpu_torch.training.metrics import psnr as psnr_fn
from waternet_tpu_torch.training.metrics import ssim as ssim_fn
from waternet_tpu_torch.utils.convert import state_dict_from_jax, vgg_state_dict_from_jax
from waternet_tpu_torch.utils.device import resolve_device
from waternet_tpu_torch.utils.tensor import to_device

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
    # codec only; lossy codecs ignore it, as in the JAX package).
    precache_histeq: bool = True
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
            "precache_vgg_ref": (self.precache_vgg_ref, "Queue A item 5 (precache tables)"),
            "host_preprocess": (self.host_preprocess, "Queue A item 5 (host-fed training)"),
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
        self._cache_enc = None
        self._val_cache = None

    # ------------------------------------------------------------------
    # Steps
    # ------------------------------------------------------------------

    def _autocast(self):
        if self.config.precision != "bf16":
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, dtype=torch.bfloat16)

    def _losses_and_out(self, x, wbn, hen, gcn, refn, mask, stamp=_no_stamp):
        with self._autocast():
            out = self.model(x, wbn, hen, gcn)
        out = out.to(torch.float32)
        stamp("forward")
        mse = mse_255(out, refn, mask)
        aux = {"mse": mse, "perceptual_loss": torch.zeros((), device=self.device)}
        loss = mse
        if self.config.perceptual_weight != 0.0:
            with self._autocast():
                perc = perceptual_loss(self.vgg, out, refn, mask)
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
        mask = self._mask(raw_u8.shape[0], n_real)
        with torch.no_grad():
            x, wbn, hen, gcn, refn = fused_train_preprocess(
                raw_u8, ref_u8, generator, augment=self.config.augment
            )
        stamp("preprocess")
        loss, out, aux = self._losses_and_out(x, wbn, hen, gcn, refn, mask, stamp)
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
        mask = self._mask(raw_u8.shape[0], n_real)
        x, wbn, hen, gcn, refn = fused_train_preprocess(raw_u8, ref_u8, None)
        _, out, aux = self._losses_and_out(x, wbn, hen, gcn, refn, mask)
        return self._metrics(out, refn, aux, mask)

    # ------------------------------------------------------------------
    # The device cache
    # ------------------------------------------------------------------

    def _preflight_cache_budget(self, n_items: int) -> str:
        """Size the cache against the device's headroom before anything is
        pinned; resolve ``auto`` to a codec (written back into the config,
        as the JAX trainer does). Raises ``CacheBudgetError``."""
        h, w = self.config.im_height, self.config.im_width
        row = cachecodec.choose_codec(
            self.config.cache_codec, n_items, h, w,
            headroom=cachecodec.resolve_headroom(self.device),
            precache_histeq=self.config.precache_histeq,
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
        only its batch."""
        codec = self._preflight_cache_budget(len(indices))
        if codec == "raw" and self.config.precache_histeq:
            raise NotImplementedError(
                "precache_histeq with the raw codec: the precache tables are "
                "not ported to waternet_tpu_torch yet (ROADMAP Queue A item 5); "
                "pass precache_histeq=False (--no-precache-histeq) or a lossy codec"
            )
        self._cache_enc = None  # free the old cache before pinning the new
        self._cache_enc = self._pin_pairs(dataset, indices, codec)
        self._cache_len = len(indices)

    def cache_resident_bytes(self) -> Optional[int]:
        """Bytes pinned by the training cache, or None without one."""
        if self._cache_enc is None:
            return None
        return sum(t.numel() * t.element_size() for t in self._cache_enc.values())

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
        step, which train_epoch_cached and benchmarks share."""
        if self._cache_enc is None:
            raise RuntimeError("call cache_dataset() before cached_train_step()")
        return self.train_step_cached_codec, (self._cache_enc,)

    def train_step_cached_codec(self, enc, idx, generator, n_real, stamp=_no_stamp):
        raw_u8, ref_u8 = self._gather_decode(enc, self.config.cache_codec, idx)
        stamp("gather_decode")
        return self.train_step(raw_u8, ref_u8, generator, n_real, stamp)

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
        or index set is asked for), with WB/GC/CLAHE run in the step. With
        ``dataset=None``: the train cache, decoded in the step."""
        if dataset is not None:
            ids = tuple(int(i) for i in indices)
            cached = self._val_cache
            if cached is None or cached[0] is not dataset or cached[1] != ids:
                self._val_cache = None
                self._val_cache = (dataset, ids, self._pin_pairs(dataset, ids, "raw"))
            enc, codec, n = self._val_cache[2], "raw", len(ids)
        else:
            if self._cache_enc is None:
                raise RuntimeError("no cached dataset for eval_epoch_cached()")
            enc, codec, n = self._cache_enc, self.config.cache_codec, self._cache_len
        self.model.eval()
        per_step = [
            self.eval_step(*self._gather_decode(enc, codec, idx), n_real)
            for idx, n_real in self._cached_index_batches(n, epoch=0, shuffle=False)
        ]
        self.model.train()
        return self._epoch_means(per_step, VAL_METRICS_NAMES)
