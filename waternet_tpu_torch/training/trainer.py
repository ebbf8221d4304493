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

Resume and resilience, as in the JAX package. All three train epochs run
through one driver, :meth:`TrainingEngine._drive_train_epoch`: steps are
dispatched without waiting and their metrics fetched once at the epoch's
end, or every ``window`` steps under a divergence sentinel. Each epoch
takes ``start_batch`` (and, host-fed, ``start_items``) to enter the epoch
at a recorded position, ``carry`` (the per-step metrics of the trained
prefix, so the epoch means equal an uninterrupted run's bit for bit) and
``control`` (:class:`~waternet_tpu_torch.resilience.EpochControl`:
preemption, the sentinel's rollback and replay, interval checkpoints,
heartbeats). :meth:`TrainingEngine.checkpoint` and :meth:`~TrainingEngine.
restore` save and load the full train state (parameters, Adam moments,
the schedule's position, the step) in the format of
:func:`~waternet_tpu_torch.utils.checkpoint.save_state_atomic`.

Distillation (``distill=True``, the fast tier): the TRAINED model is a
CAN student (``models/can.py``, ``student_width`` x ``student_depth``)
mapping raw RGB to the output of a frozen WaterNet teacher
(``teacher_params``), which runs in the step under ``no_grad`` on the
WB/GC/CLAHE planes the step makes anyway; the teacher's output replaces
the reference in every loss and metric, so val ssim/psnr read as
student-against-teacher fidelity. Everything else (the feeds, the
caches, resume) is the same machinery.

Multi-GPU, as the JAX package's mesh does it, in PyTorch's idiom:

* **data parallel**: with ``torch.distributed`` initialized
  (:mod:`waternet_tpu_torch.parallel.distributed`), each process trains one
  data shard. ``DistributedDataParallel`` wraps the trained module (it
  broadcasts rank 0's parameters at construction and averages the
  gradients). Every rank builds the same global batch from the seed, as
  every JAX host does (a device cache holds the whole set on every rank);
  the augmentation is drawn for the global batch; each rank pads the batch
  to a multiple of the world size by repeating its last row and takes its
  :func:`~waternet_tpu_torch.parallel.distributed.local_batch_slice`, the
  pad masked. The rank's loss is scaled by ``world * local_real /
  global_real`` so that the averaged gradient is the single-process mean
  over the global batch, and the step's metric sums (and SSIM's data
  range) are all-reduced so that every rank logs the global metrics. Eval
  runs the whole val set on every rank, unsharded.
* **spatial** (``spatial_shards > 1``): within one process, over its
  ``spatial_shards`` devices (process r owns ``[r*S, (r+1)*S)``, or the
  ``devices`` given), the WaterNet forward and backward run through
  :func:`~waternet_tpu_torch.parallel.spatial.spatial_sharded_apply`, the
  parameters broadcast differentiably to distinct cards
  (``torch.nn.parallel.replicate``); the outputs are gathered to the first
  device and the losses (MSE, SSIM, VGG perceptual) run there on the whole
  image: the same math as the JAX package's SPMD step, with the loss not
  sharded. Distillation supports data parallelism only, as in the JAX
  package.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import time
from pathlib import Path
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
from waternet_tpu_torch.models import CANStudent, WaterNet, waternet_forward_flops
from waternet_tpu_torch.models.can import train_flops_per_image
from waternet_tpu_torch.models.vgg import VGG19Features, imagenet_normalize, init_vgg_params
from waternet_tpu_torch.obs import device as obsdevice
from waternet_tpu_torch.obs import trace
from waternet_tpu_torch.obs import window as obswin
from waternet_tpu_torch.ops.clahe import histeq
from waternet_tpu_torch.ops.fused import fused_train_preprocess
from waternet_tpu_torch.ops.gamma import gamma_correction
from waternet_tpu_torch.ops.transform import transform_np
from waternet_tpu_torch.parallel import distributed as pdist
from waternet_tpu_torch.ops.wb import white_balance
from waternet_tpu_torch.resilience import faults
from waternet_tpu_torch.resilience.preemption import Preempted
from waternet_tpu_torch.training.losses import PERCEPTUAL_WEIGHT, mse_255, perceptual_loss
from waternet_tpu_torch.training.metrics import psnr as psnr_fn
from waternet_tpu_torch.training.metrics import ssim as ssim_fn
from waternet_tpu_torch.training.metrics import ssim_per_image
from waternet_tpu_torch.utils.checkpoint import load_state, params_mismatch_report, save_state_atomic
from waternet_tpu_torch.utils.convert import state_dict_from_jax, vgg_state_dict_from_jax
from waternet_tpu_torch.utils.device import resolve_device
from waternet_tpu_torch.utils.tensor import DeviceFeeder, to_device

TRAIN_METRICS_NAMES = ["mse", "ssim", "psnr", "perceptual_loss", "loss"]
VAL_METRICS_NAMES = ["mse", "ssim", "psnr", "perceptual_loss"]


class CheckpointMismatchError(ValueError):
    """A checkpoint that loads but does not fit this engine's model.

    Distinct from a corrupt or truncated file so that ``--resume auto``
    can tell the two apart: corruption falls back to the previous
    checkpoint; a mismatch aborts with the shape report (falling back
    would silently retrain from scratch, since every checkpoint of the
    run would fail the same way).
    """


class TrainPerf:
    """Windowed training-performance instruments riding the epoch driver
    (the JAX package's ``TrainPerf``).

    Fed only from host clocks the loop already reads (the span between
    two dispatches) and each batch's image count, so arming it adds no
    device sync. The MFU gauge is arithmetic: windowed images/s times the
    analytic per-image training FLOPs over the card's peak
    (:mod:`waternet_tpu_torch.obs.device`); the memory gauges read
    ``torch.cuda`` once per epoch, and stay ``None`` (never 0) off CUDA.
    """

    def __init__(self, flops_per_image=None, peak_tflops=None, clock=None):
        #: Train-step FLOPs per image of the run's plane; None disables MFU.
        self.flops_per_image = flops_per_image
        self.peak_tflops = peak_tflops
        self.step_ms = obswin.WindowedHistogram(clock=clock)
        self.images = obswin.WindowedCounter(clock=clock)
        self.mfu = obswin.Gauge()
        self.hbm_peak = obswin.Gauge()

    def note_step(self, dt_s: float, n_images: int) -> None:
        """One dispatched step: ``dt_s`` host seconds since the previous
        dispatch, ``n_images`` real rows."""
        self.step_ms.record(dt_s * 1e3)
        if n_images > 0:
            self.images.add(n_images)

    def images_per_sec(self) -> float:
        return self.images.rate(obswin.DEFAULT_WINDOW_SEC)

    def update_gauges(self, device=None) -> None:
        """Epoch-boundary refresh: live MFU from the windowed rate, and the
        device's memory high-water mark where it reports one."""
        if self.flops_per_image and self.peak_tflops:
            ips = self.images_per_sec()
            if ips > 0:
                self.mfu.set(ips * self.flops_per_image / 1e12 / self.peak_tflops)
        if device is not None:
            peak = obsdevice.hbm_peak_bytes(device)
            if peak is not None:
                self.hbm_peak.set(peak)

    def epoch_snapshot(self) -> dict:
        """The per-epoch perf row (``train --perf-csv``): windowed step-time
        quantiles and throughput, live MFU and peak device memory, None
        where unmeasurable."""
        steps = self.step_ms.merged(obswin.DEFAULT_WINDOW_SEC)
        return {
            "step_ms_p50": round(steps.quantile(0.50), 3),
            "step_ms_p99": round(steps.quantile(0.99), 3),
            "images_per_sec_window": round(self.images_per_sec(), 3),
            "mfu_live": round(self.mfu.last(), 5) if self.mfu.last() is not None else None,
            "hbm_peak_bytes": int(self.hbm_peak.peak()) if self.hbm_peak.peak() is not None else None,
        }


def _fetch_floats(per_step: list) -> list:
    """Per-step metric dicts of 0-d device tensors -> dicts of Python
    floats, read back in one copy."""
    if not per_step:
        return []
    # jaxlint: disable-next=R003 one batched read of the metrics: after the loop, or once a sentinel window
    flat = torch.stack([v.detach().float().reshape(()) for m in per_step for v in m.values()]).cpu().tolist()
    out, i = [], 0
    for m in per_step:
        out.append(dict(zip(m, flat[i : i + len(m)])))
        i += len(m)
    return out


def _means(per_step: list, names) -> dict:
    """The mean of each metric over the steps' float dicts: a float sum
    in step order over the count, as the JAX package's epochs take it."""
    return {k: sum(m[k] for m in per_step) / max(len(per_step), 1) for k in names}


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
    # Distill the whole quality pipeline into a CAN student: the trained
    # model becomes the student; a frozen WaterNet teacher runs in the
    # step on the WB/GC/CLAHE planes the step makes anyway, and its output
    # replaces the reference in every loss and metric.
    distill: bool = False
    student_width: int = 24
    student_depth: int = 7
    cache_codec: str = "raw"

    def check_ported(self) -> None:
        """Validate the fields. Every field's path is ported, so nothing
        raises for being missing; a value no path takes raises
        ``ValueError``, the JAX package's rules and messages."""
        if self.spatial_shards < 1:
            raise ValueError(f"spatial_shards must be >= 1, got {self.spatial_shards}")
        if self.distill and self.spatial_shards > 1:
            raise ValueError(
                "distillation supports data parallelism only for now "
                "(the student's dilated convs would need 64-row halos)"
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


class SpatialForward(torch.nn.Module):
    """WaterNet's forward H-sharded over ``devices`` (one process's spatial
    group): a module, so that ``DistributedDataParallel`` can wrap it. The
    parameters stay on the first device; distinct devices get replicas by
    ``torch.nn.parallel.replicate``, a broadcast that autograd reduces
    back, and shards on one device share the module itself (the same
    arithmetic)."""

    def __init__(self, net: torch.nn.Module, devices):
        from waternet_tpu_torch.parallel.mesh import make_mesh

        super().__init__()
        self.net = net
        self.mesh = make_mesh(1, len(devices), devices)
        self.distinct = list(dict.fromkeys(self.mesh.spatial_devices()))

    def forward(self, x, wb, he, gc):
        from waternet_tpu_torch.parallel.spatial import spatial_sharded_apply

        if len(self.distinct) == 1:
            replicas = {self.distinct[0]: self.net}
        else:
            replicas = dict(zip(self.distinct, torch.nn.parallel.replicate(self.net, self.distinct)))
        return spatial_sharded_apply(replicas, self.mesh)(x, wb, he, gc)


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


def _student_params(params) -> dict:
    from waternet_tpu_torch.models.can import student_state_dict

    return {k: torch.as_tensor(v) for k, v in student_state_dict(params).items()}


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
        teacher_params: Optional[dict] = None,
        devices=None,
    ):
        """``params``: the trained model's weights as the JAX tree (nested or
        flat keys; converted) or as a port state_dict; None draws the port's
        own init under ``torch.manual_seed(config.seed)``. ``vgg_params``
        likewise (JAX tree or ``features.*`` state_dict); None with the
        perceptual term on takes the deterministic random init. With
        ``config.distill`` the trained model is the CAN student and
        ``teacher_params`` (WaterNet weights, required) the frozen teacher.

        ``devices``: with ``config.spatial_shards > 1``, the process's
        spatial group (may repeat a device); by default the process's own
        devices (:func:`~waternet_tpu_torch.parallel.distributed.
        process_devices`). ``device`` is then the group's first. With
        ``torch.distributed`` initialized over several processes the
        engine trains data-parallel (see the module docstring)."""
        config.check_ported()
        self.config = config
        self.device = resolve_device(device)
        self._world, self._rank = pdist.process_count(), pdist.process_index()
        self.devices = [self.device]
        if config.spatial_shards > 1:
            if devices is None:
                devices = pdist.process_devices(self.device, config.spatial_shards, self._rank)
            self.devices = [resolve_device(d) for d in devices]
            if len(self.devices) != config.spatial_shards:
                raise ValueError(f"spatial_shards={config.spatial_shards} needs as many devices, "
                                 f"got {len(self.devices)}")
            self.device = self.devices[0]
        if config.distill:
            if teacher_params is None:
                raise ValueError(
                    "distillation needs frozen teacher weights: pass teacher_params "
                    "(CLI: --teacher-weights, or the standard weight resolution)"
                )
            # The TRAINED model is the student; the teacher is a frozen
            # constant of the loss, never part of the optimizer state.
            build = lambda: CANStudent(config.student_width, config.student_depth)  # noqa: E731
            to_sd = _student_params
            self.teacher = WaterNet()
            self.teacher.load_state_dict(_waternet_state_dict(teacher_params), strict=True)
            self.teacher.to(self.device).eval().requires_grad_(False)
        else:
            build, to_sd, self.teacher = WaterNet, _waternet_state_dict, None
        if params is None:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(config.seed)
                sd = build().state_dict()
        else:
            sd = to_sd(params)
        self.model = build()
        self.model.load_state_dict(sd, strict=True)
        self.model.to(self.device).train()
        # The forward the steps call: the model, or its spatially sharded
        # forward; under several processes, DDP over it (trained steps only:
        # eval calls ``_fwd`` and runs no collective).
        self._fwd = self.model if config.spatial_shards == 1 else SpatialForward(self.model, self.devices)
        self._net = self._fwd
        if self._world > 1:
            from torch.nn.parallel import DistributedDataParallel

            self._net = DistributedDataParallel(self._fwd)

        self.vgg = None
        if config.perceptual_weight != 0.0:
            vsd = init_vgg_params() if vgg_params is None else _vgg_state_dict(vgg_params)
            self.vgg = VGG19Features()
            self.vgg.load_state_dict(vsd, strict=True)
            self.vgg.to(self.device).eval().requires_grad_(False)

        self.optimizer, self.scheduler = make_optimizer(self.model.parameters(), config)
        # Dispatched train steps, counted on the host: the fault plans'
        # keys and the checkpoint manager's step names. A rollback does not
        # rewind it (replays count again), as in the JAX package.
        self._host_step = 0
        # Windowed perf instruments, fed from host clocks (see TrainPerf):
        # the trained network's forward and backward, 3x its forward's
        # FLOPs, per image (plus the teacher's forward under distillation).
        h, w = config.im_height, config.im_width
        if config.distill:
            flops = train_flops_per_image(h, w, config.student_width, config.student_depth, distill=True)
        else:
            flops = 3 * waternet_forward_flops(h, w)
        self.perf = TrainPerf(
            flops_per_image=flops,
            peak_tflops=obsdevice.peak_tflops(self.device, config.precision),
        )
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
        aux = {}
        net = self._net if torch.is_grad_enabled() else self._fwd
        if self.teacher is not None:
            # Frozen teacher: the full quality pipeline's output (the
            # batch's WB/GC/CLAHE planes are its variant inputs) replaces
            # the reference in every loss AND metric.
            with torch.no_grad(), self._autocast():
                refn = self.teacher(x, wbn, hen, gcn).to(torch.float32)
            ref_feats = None  # precached vgg(ref) features target the wrong image
            aux["target"] = refn
            with self._autocast():
                out = net(x)
        else:
            with self._autocast():
                out = net(x, wbn, hen, gcn)
        out = out.to(torch.float32)
        stamp("forward")
        mse = mse_255(out, refn, mask)
        aux.update(mse=mse, perceptual_loss=torch.zeros((), device=self.device))
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
        refn = aux.get("target", refn)  # distillation: student against teacher
        m = {
            "mse": aux["mse"].detach(),
            "ssim": ssim_fn(out, refn, mask=mask),
            "psnr": psnr_fn(out, refn, data_range=1.0, mask=mask),
            "perceptual_loss": aux["perceptual_loss"].detach(),
        }
        if loss is not None:
            m["loss"] = loss.detach()
        return m

    @torch.no_grad()
    def _global_metrics(self, out, refn, aux, mask, n_global: int) -> dict:
        """The step's metrics over the global batch, the same on every rank:
        the per-rank masked sums all-reduced (one MAX for SSIM's data range
        over the global batch, one SUM), then divided by the global count."""
        dist = torch.distributed
        refn = aux.get("target", refn)
        n_local = mask.sum()
        ranges = torch.stack([out.max(), -out.min(), refn.max(), -refn.min()]).to(torch.float32)
        dist.all_reduce(ranges, op=dist.ReduceOp.MAX)
        data_range = torch.maximum(ranges[0] + ranges[1], ranges[2] + ranges[3])
        m = mask.to(torch.float32)
        sq = torch.square(out.to(torch.float32) - refn.to(torch.float32))
        sums = torch.stack([
            aux["mse"].detach() * n_local,
            aux["perceptual_loss"].detach() * n_local,
            (ssim_per_image(out, refn, data_range=data_range) * m).sum(),
            (sq.reshape(sq.shape[0], -1).mean(dim=-1) * m).sum(),
        ]).to(torch.float32)
        dist.all_reduce(sums)
        mse, perc, ssim, sq_mean = sums / n_global
        loss = mse if self.config.perceptual_weight == 0.0 else self.config.perceptual_weight * perc + mse
        return {"mse": mse, "ssim": ssim, "psnr": 10.0 * torch.log10(1.0 / sq_mean),
                "perceptual_loss": perc, "loss": loss}

    def _mask(self, n: int, n_real: int) -> torch.Tensor:
        return torch.arange(n, device=self.device) < n_real

    def _local_rows(self, n_real: int):
        """Data parallel: the rows of the ``n_real``-row global batch this
        rank trains (a CPU index tensor; the batch padded to a multiple of
        the world size by repeating its last row) and how many of them are
        real. The padded rows come last, so a rank's real rows lead."""
        padded = -(-n_real // self._world) * self._world
        sl = pdist.local_batch_slice(padded, self._rank, self._world)
        rows = torch.arange(sl.start, sl.stop).clamp_max(n_real - 1)
        return rows, max(0, min(sl.stop, n_real) - sl.start)

    def _split_step(self, n: int, n_real: int, generator):
        """``(draws, rows, n_local)`` of one step over an n-row batch: the
        augmentation drawn for the whole (global) batch, or None when the
        step does not augment; under data parallelism the rows this rank
        trains (:meth:`_local_rows`) and the draws cut to them, else
        ``rows`` None and every row this process's."""
        draws = None
        if self.config.augment and generator is not None:
            draws = draw_augment(generator, n)
        if self._world == 1:
            return draws, None, n_real
        rows, n_local = self._local_rows(n_real)
        if draws is not None:
            draws = tuple(d.index_select(0, rows) for d in draws)
        return draws, rows, n_local

    def train_step(self, raw_u8, ref_u8, generator, n_real: int, stamp=_no_stamp) -> dict:
        """One optimizer step on a uint8 (N, H, W, 3) pair batch on the
        engine's device; returns the step's metrics as 0-d device tensors
        (nothing is read back). Under data parallelism the batch is the
        global one, and the step trains this rank's rows."""
        draws, rows, n_local = self._split_step(raw_u8.shape[0], n_real, generator)
        if rows is not None:
            r = to_device(rows, self.device)
            raw_u8, ref_u8 = raw_u8.index_select(0, r), ref_u8.index_select(0, r)
        return self._train_u8(raw_u8, ref_u8, draws, n_local, None if rows is None else n_real, stamp)

    def _train_u8(self, raw_u8, ref_u8, draws, n_real, n_global, stamp):
        with torch.no_grad():
            views = fused_train_preprocess(raw_u8, ref_u8, None, augment=self.config.augment, draws=draws)
        stamp("preprocess")
        return self.train_step_pre(*views, n_real, stamp=stamp, n_global=n_global)

    def train_step_pre(self, x, wbn, hen, gcn, refn, n_real: int, stamp=_no_stamp, ref_feats=None,
                       n_global: Optional[int] = None) -> dict:
        """One optimizer step on the five float32 [0, 1] views, in the
        network's input order; no transform runs inside it. ``ref_feats``
        (precache_vgg_ref) stands in for VGG's features of ``refn``.
        ``n_global`` (data parallel): the views are this rank's rows, the
        first ``n_real`` of them real, of a global batch of ``n_global``
        real rows."""
        mask = self._mask(x.shape[0], n_real)
        loss, out, aux = self._losses_and_out(x, wbn, hen, gcn, refn, mask, stamp, ref_feats)
        self.optimizer.zero_grad(set_to_none=True)
        if n_global is None:
            loss.backward()
        else:
            # DDP averages the ranks' gradients: this scale makes the average
            # the gradient of the mean over the global batch.
            (loss * (self._world * n_real / n_global)).backward()
        stamp("backward")
        self.optimizer.step()
        self.scheduler.step()
        stamp("optimizer")
        if n_global is None:
            m = self._metrics(out.detach(), refn, aux, mask, loss)
        else:
            m = self._global_metrics(out.detach(), refn, aux, mask, n_global)
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
        if cfg.precache_vgg_ref and cfg.distill:
            # The table holds vgg(ground-truth ref); the distillation target
            # is the teacher's output, whose features the step must compute.
            raise ValueError(
                "precache_vgg_ref is incompatible with distill: the distillation target is "
                "the teacher output, not the ground-truth ref the table was built from"
            )
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

    def _cached_index_batches(self, n: int, epoch: int, shuffle: bool, start: int = 0):
        """Yield (idx, n_real) covering all n items from batch ``start`` on:
        the JAX trainer's batch composition (the same Philox shuffle),
        without its padding to the data axis (a data-parallel step pads
        and cuts each batch itself)."""
        b = self.config.batch_size
        order = epoch_permutation(np.arange(n), self.config.seed, epoch) if shuffle else np.arange(n)
        for s in range(start * b, n, b):
            idx = order[s : s + b].astype(np.int64)
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
        """The cached step over a codec's planes: gather and decode the
        batch, then :meth:`train_step`; data parallel, gather and decode
        this rank's rows only."""
        if self._world == 1:
            raw_u8, ref_u8 = self._gather_decode(enc, self.config.cache_codec, idx)
            stamp("gather_decode")
            return self.train_step(raw_u8, ref_u8, generator, n_real, stamp)
        draws, rows, n_local = self._split_step(idx.shape[0], n_real, generator)
        idx = idx.index_select(0, to_device(rows, self.device))
        raw_u8, ref_u8 = self._gather_decode(enc, self.config.cache_codec, idx)
        stamp("gather_decode")
        return self._train_u8(raw_u8, ref_u8, draws, n_local, n_real, stamp)

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
        in-step raw-cache step bit for bit. Data parallel: the draws are
        made for the global batch and this rank gathers its rows only."""
        draws, rows, n_local = self._split_step(idx.shape[0], n_real, generator)
        if rows is not None:
            idx = idx.index_select(0, to_device(rows, self.device))
        raw, ref, wb, gc = self._gather_pre(cache, idx)
        stamp("gather_decode")
        if draws is not None:
            square = self.config.im_height == self.config.im_width
            hflip, vflip, rotk = draws
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
                                   n_local, stamp=stamp, ref_feats=ref_feats,
                                   n_global=None if rows is None else n_real)

    @torch.no_grad()
    def eval_step_cached_pre(self, cache, idx, n_real):
        """Eval over precache tables: no augmentation, so every image reads
        the identity variant's row 0."""
        raw, ref, wb, gc = self._gather_pre(cache, idx)
        he = cache["he"][0].index_select(0, idx).to(torch.float32)
        ref_feats = None if cache["vgg_ref"] is None else cache["vgg_ref"][0].index_select(0, idx)
        return self.eval_step_pre(raw / 255.0, wb / 255.0, he / 255.0, gc / 255.0, ref / 255.0,
                                  n_real, ref_feats=ref_feats)

    def train_epoch_cached(self, epoch: int, *, start_batch: int = 0, control=None, carry=None) -> dict:
        """One epoch over the cached dataset; the mean of the per-step
        metrics, read back once at the epoch's end (see
        :meth:`_drive_train_epoch` for ``start_batch``, ``control`` and
        ``carry``)."""
        step_fn, cache_args = self.cached_train_step()
        self.model.train()
        batches = self._cached_index_batches(self._cache_len, epoch, self.config.shuffle, start_batch)
        payloads = ((count, {"idx": idx, "n_real": n_real}) for count, (idx, n_real) in enumerate(batches, start_batch))

        def dispatch(count, payload):
            gen = step_generator(self.config.seed, epoch, count)
            return self._post_step(step_fn(*cache_args, payload["idx"], gen, payload["n_real"]))

        return self._drive_train_epoch(payloads, dispatch, control, carry)

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
        return _means(_fetch_floats(per_step), VAL_METRICS_NAMES)

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
        step's own generator as in ``train_epoch_cached``. Data parallel:
        the batch is the global one (the five views cut to this rank's rows
        here; the uint8 pair in :meth:`train_step`)."""
        if self.config.host_preprocess:
            if self._world > 1:
                rows, n_local = self._local_rows(n_real)
                r = to_device(rows, self.device)
                return self.train_step_pre(*(t.index_select(0, r) for t in tensors), n_local, n_global=n_real)
            return self.train_step_pre(*tensors, n_real)
        return self.train_step(*tensors, step_generator(self.config.seed, epoch, count), n_real)

    def _eval_on(self, tensors, n_real: int) -> dict:
        if self.config.host_preprocess:
            return self.eval_step_pre(*tensors, n_real)
        return self.eval_step(*tensors, n_real)

    def _feed(self, arrays):
        """Host arrays -> device tensors, on the consumer's thread."""
        return self._feeder.receive(self._feeder.send(arrays))

    def _host_augment_rng(self, epoch: int, start_batch: int = 0, start_items: Optional[int] = None):
        """The host augment stream of ``epoch``, ``default_rng(seed + 7 +
        epoch)``, advanced past the first ``start_batch`` batches without
        data: they held ``start_items`` items (default ``start_batch *
        batch_size``), and each batch of n items drew n items' draws (the
        port pads no batch)."""
        rng = np.random.default_rng(self.config.seed + 7 + epoch)
        if self.config.host_preprocess and self.config.augment:
            b = self.config.batch_size
            total = start_batch * b if start_items is None else start_items
            for k in range(start_batch):
                n_real = min(b, total - k * b)
                if n_real <= 0:
                    break
                advance_augment_rng(rng, n_real)
        return rng

    def train_epoch(
        self, batch_iter, epoch: int, *, start_batch: int = 0, start_items: Optional[int] = None,
        control=None, carry=None,
    ) -> dict:
        """One synchronous host-fed epoch over ``(raw_u8, ref_u8)`` numpy
        batches; the mean of the per-step metrics. With ``host_preprocess``
        the batches are augmented from one numpy stream, ``default_rng(seed
        + 7 + epoch)``, batch after batch.

        Mid-epoch resume: ``batch_iter`` yields the batches from
        ``start_batch`` on (``dataset.batches(..., start=start_batch)``),
        and ``start_items``, the item count of the skipped prefix, moves the
        host augment stream past it. ``control`` and ``carry`` as in
        :meth:`_drive_train_epoch`."""
        host_rng = self._host_augment_rng(epoch, start_batch, start_items)
        self.model.train()
        payloads = ((count, {"raw": raw, "ref": ref, "n_real": raw.shape[0]})
                    for count, (raw, ref) in enumerate(batch_iter, start_batch))

        def dispatch(count, payload):
            if "tensors" not in payload:  # a replay reuses the first dispatch's tensors
                raw, ref = payload.pop("raw"), payload.pop("ref")
                arrays = self._host_preprocess_np(raw, ref, host_rng) if self.config.host_preprocess else (raw, ref)
                payload["tensors"] = self._feed(arrays)
            return self._post_step(self._train_on(epoch, count, payload["tensors"], payload["n_real"]))

        return self._drive_train_epoch(payloads, dispatch, control, carry)

    def _post_step(self, metrics: dict) -> dict:
        """After each dispatched step: count it on the host and run the
        fault-injection hook (an ``is None`` check without a plan)."""
        self._host_step += 1
        return faults.after_train_step(self, metrics, self._host_step)

    def _drive_train_epoch(self, payloads, dispatch, control=None, carry=None) -> dict:
        """The train epochs' shared driver: deferred metric fetch, and the
        resilience controls (the JAX package's ``_drive_train_epoch``).

        ``payloads`` yields ``(count, payload)``, ``count`` the batch's
        index in the epoch; ``dispatch(count, payload)`` runs one step and
        returns its metrics as 0-d device tensors. Dispatching the same
        payload again must repeat the step bit for bit: each step's batch,
        generator and augment draws are functions of (seed, epoch, count),
        and a host-fed payload keeps the tensors its first dispatch made.
        That is what makes the sentinel's replay and mid-epoch resume
        exact.

        ``carry``: the per-step metric dicts (floats) of the batches before
        the first payload, when resuming mid-epoch; the epoch means cover
        them. ``control`` (:class:`~waternet_tpu_torch.resilience.
        EpochControl`) is consulted after each step: a heartbeat; under a
        divergence sentinel, a fetch every ``window`` steps, and on a
        non-finite step a rollback to the last verified snapshot, a replay
        of the verified-good steps without the bad batch, and a re-check;
        a preemption raises :class:`~waternet_tpu_torch.resilience.
        Preempted` ``(next batch, per-step metrics so far)`` after
        fetching; a due interval checkpoint is taken at the boundary it
        fires on. With ``control=None`` every step is dispatched and the
        metrics are read back once, at the end.

        Returns the mean of each metric over the epoch's steps (sums of
        floats, as the JAX package), with ``nan_skipped`` and
        ``nan_rollbacks`` under a sentinel."""
        fetched = [dict(m) for m in carry] if carry else []
        pending = []  # [(count, payload or None, device metrics)]
        sentinel = control.sentinel if control is not None else None
        snapshot = None
        if sentinel is not None:
            sentinel.begin_epoch()
            snapshot = self._host_state_copy()

        def verify():
            """Fetch the pending metrics; under a sentinel, on the first
            non-finite one restore the snapshot, replay the good steps
            without the bad one, and check again (each pass drops a batch,
            and the sentinel's budget bounds the passes)."""
            nonlocal pending, snapshot
            while pending:
                t_fetch0 = time.perf_counter() if trace.enabled() else None
                vals = _fetch_floats([m for _, _, m in pending])
                if t_fetch0 is not None:
                    trace.record_span("metrics_fetch", "training", t_fetch0, time.perf_counter(),
                                      args={"steps": len(pending), "first": pending[0][0], "last": pending[-1][0]})
                bad = sentinel.first_bad(vals) if sentinel is not None else None
                if bad is None:
                    fetched.extend(vals)
                    pending = []
                    break
                sentinel.note_skip(pending[bad][0])
                self._own_device_state(snapshot)
                replay = pending[:bad] + pending[bad + 1 :]
                pending = [(cnt, payload, dispatch(cnt, payload)) for cnt, payload, _ in replay]
            if sentinel is not None:
                snapshot = self._host_state_copy()

        t_prev = None
        for count, payload in payloads:
            t_step0 = time.perf_counter() if trace.enabled() else None
            metrics = dispatch(count, payload)
            # Only a sentinel's replay needs the payload again; dropping it
            # otherwise frees a host-fed batch's device tensors after its step.
            pending.append((count, payload if sentinel is not None else None, metrics))
            if t_step0 is not None:
                trace.record_span("step_dispatch", "training", t_step0, time.perf_counter(),
                                  args={"batch": count, "step": self._host_step})
            if obswin.enabled():
                # The span between dispatches: at steady state the host waits
                # on the device's queue, so this tracks the step time.
                t_now = time.perf_counter()
                if t_prev is not None:
                    self.perf.note_step(t_now - t_prev, payload["n_real"])
                t_prev = t_now
            if control is None:
                continue
            if control.heartbeat is not None:
                control.heartbeat.beat(step=self._host_step)
            if sentinel is not None and len(pending) >= sentinel.window:
                verify()
            if control.preempt_requested():
                verify()
                raise Preempted(count + 1, fetched)
            if control.checkpoint_due():
                verify()
                control.checkpoint(count + 1, fetched)
        verify()
        if obswin.enabled():
            self.perf.update_gauges(self.device)
        out = _means(fetched, TRAIN_METRICS_NAMES)
        if sentinel is not None:
            out["nan_skipped"] = float(sentinel.skipped)
            out["nan_rollbacks"] = float(sentinel.rollbacks)
        return out

    def eval_epoch(self, batch_iter) -> dict:
        """Synchronous host-fed eval over ``(raw_u8, ref_u8)`` numpy batches
        (no augmentation)."""
        self.model.eval()
        per_step = []
        for raw, ref in batch_iter:
            arrays = self._host_preprocess_np(raw, ref) if self.config.host_preprocess else (raw, ref)
            per_step.append(self._eval_on(self._feed(arrays), raw.shape[0]))
        self.model.train()
        return _means(_fetch_floats(per_step), VAL_METRICS_NAMES)

    def _epoch_plan(self, indices, epoch: int, shuffle: bool, start_batch: int = 0):
        """``[(count, index_chunk)]`` for one epoch from batch ``start_batch``
        on: the batches of :func:`~waternet_tpu_torch.data.batching.
        iter_batches` (same Philox stream) as a work list whose items
        workers may produce in any order; the skipped ones are not loaded."""
        order = epoch_permutation(indices, self.config.seed, epoch) if shuffle else np.array(indices, copy=True)
        b = self.config.batch_size
        return [(count, order[s : s + b]) for count, s in enumerate(range(0, len(order), b)) if count >= start_batch]

    def _plan_augment_states(self, plan, epoch: int, start_batch: int = 0, start_items: Optional[int] = None):
        """Each batch's start state of the host augment stream, or None when
        the stream is unused. The consumer advances the one stream the
        synchronous epoch draws from (past the skipped prefix, as
        :meth:`_host_augment_rng` does), without data, and records where
        each batch starts; a worker clones its batch's state and makes the
        same draws in any completion order. A batch of n items consumes n
        items' draws: the host augments the global batch, unpadded."""
        if not (self.config.host_preprocess and self.config.augment):
            return None
        host_rng = self._host_augment_rng(epoch, start_batch, start_items)
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
        consumer keeps no batch past its step, only its 0-d metrics (under
        a divergence sentinel, past the sentinel's window)."""

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

    def train_epoch_pipelined(
        self, dataset, indices, epoch: int, *, workers: int = 2, prefetch: int = 0, start_batch: int = 0,
        start_items: Optional[int] = None, control=None, carry=None,
    ) -> dict:
        """Overlapped host-fed epoch: equal, bit for bit, to
        :meth:`train_epoch` over ``dataset.batches(indices, ...)`` (same
        batches, same augment draws, same steps), with loading, host
        preprocessing and the copy to the device of later batches running
        on ``workers`` threads while the current step runs. ``workers=0``
        runs the same code inline. The steps are dispatched on the
        consumer's thread through :meth:`_drive_train_epoch`, so resume
        (``start_batch``, ``start_items``), ``control`` and ``carry`` behave
        as in :meth:`train_epoch`; a preemption or an error closes the
        pipeline (its workers joined, its queued batches dropped) before it
        propagates. The metrics gain the ``pipeline_*`` keys: stall pct,
        per-stage ms, queue depth, workers, and the transfer bytes per
        batch."""
        plan = self._epoch_plan(indices, epoch, self.config.shuffle, start_batch)
        aug_states = self._plan_augment_states(plan, epoch, start_batch, start_items)
        stats = PipelineStats()
        self.model.train()

        def dispatch(count, payload):
            with stats.stage("step"):
                return self._post_step(self._train_on(epoch, count, payload["tensors"], payload["n_real"]))

        pipe = OrderedPipeline(self._pipeline_produce(dataset, aug_states, stats), plan,
                               workers=workers, prefetch=prefetch, stats=stats, name="train")
        payloads = ((count, {"tensors": self._feeder.receive(sent), "n_real": n_real})
                    for count, sent, n_real in pipe)
        try:
            out = self._drive_train_epoch(payloads, dispatch, control, carry)
        finally:
            pipe.close()
        out.update(stats.metrics())
        return out

    def eval_epoch_pipelined(self, dataset, indices, *, workers: int = 2, prefetch: int = 0) -> dict:
        """Pipelined counterpart of :meth:`eval_epoch` (no shuffle, no
        augmentation): the same metric values, plus the ``pipeline_*`` keys."""
        plan = self._epoch_plan(indices, epoch=0, shuffle=False)
        stats = PipelineStats()
        per_step = []
        self.model.eval()
        with OrderedPipeline(self._pipeline_produce(dataset, None, stats), plan,
                             workers=workers, prefetch=prefetch, stats=stats, name="eval") as pipe:
            for _, sent, n_real in pipe:
                with stats.stage("step"):
                    per_step.append(self._eval_on(self._feeder.receive(sent), n_real))
        self.model.train()
        out = _means(_fetch_floats(per_step), VAL_METRICS_NAMES)
        out.update(stats.metrics())
        return out

    # ------------------------------------------------------------------
    # The full train state: checkpoint, restore, rollback snapshots
    # ------------------------------------------------------------------

    def train_state(self) -> dict:
        """The live train state, as references to the live tensors:
        ``{"model", "optimizer", "scheduler", "step"}``, the WaterNet, Adam
        and schedule state_dicts and the optimizer step count. Copy it
        before the next step if it must not change (:meth:`_host_state_copy`,
        :meth:`checkpoint`)."""
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "scheduler": self.scheduler.state_dict(),
            "step": int(self.scheduler.last_epoch),
        }

    def load_train_state(self, state: dict) -> None:
        """Load a train state (what :meth:`train_state` returns, what a
        checkpoint holds, or what :func:`~waternet_tpu_torch.utils.convert.
        train_state_from_jax` makes) into the live model, optimizer and
        schedule. Loads a copy: ``Optimizer.load_state_dict`` keeps the
        tensors it is given when they already sit on the parameters' device
        (Adam's per-parameter ``step`` always), and the next step updates
        them in place, so loading ``state`` itself would let training
        rewrite it."""
        state = copy.deepcopy(state)
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])

    def checkpoint(self, path) -> None:
        """Save the full train state (parameters, Adam moments, the
        schedule's position, the step) to the directory ``path``,
        atomically (:func:`~waternet_tpu_torch.utils.checkpoint.
        save_state_atomic`): the reference saved weights only and so reset
        Adam and the schedule on resume."""
        save_state_atomic(self.train_state(), path)

    def restore(self, path) -> None:
        """Restore the full train state saved at ``path``.

        Reads the whole file before touching the engine, so a truncated or
        corrupt checkpoint raises and leaves the engine as it was. A state
        that does not fit this engine's model raises
        :class:`CheckpointMismatchError` naming each tensor that differs.
        Read onto the CPU: the optimizer copies the moments to the
        parameters' device and keeps Adam's step counts on the CPU, where
        a non-capturable Adam reads them."""
        path = Path(path).absolute()
        state = load_state(path, map_location="cpu")
        report = params_mismatch_report(state["model"], self.model.state_dict())
        if report:
            raise CheckpointMismatchError(f"checkpoint at {path} does not fit the model config:\n{report}")
        self.load_train_state(state)
        self._host_step = int(state["step"])

    def _host_state_copy(self) -> dict:
        """A snapshot of the live train state for the sentinel's rollback:
        every tensor cloned (Adam's per-parameter ``step`` included) where
        it lives, so the snapshot stays on the card (~13 MB of parameters
        and moments) and no later step changes it."""
        return copy.deepcopy(self.train_state())

    def _own_device_state(self, snapshot: dict) -> None:
        """Roll the live state back to ``snapshot`` (a copy of it: the
        snapshot stays valid for another rollback). ``_host_step`` keeps
        counting dispatches."""
        self.load_train_state(snapshot)
