"""Training CLI of the port: WaterNet trained host-fed or from a device cache.

    python -m waternet_tpu_torch.train --data-root data --workers 2
    python -m waternet_tpu_torch.train --synthetic 64 --device-cache \\
        --cache-codec dct8 --height 256 --width 256 --batch-size 8

The flags follow the JAX package's ``train.py``. The data is UIEB under
``--data-root`` (``raw-890/`` and ``reference-890/``, the reference's
seed-0 split, corrupt pairs quarantined up front) or ``--synthetic N``
pairs. Three ways to feed the steps:

* host-fed and overlapped (the default, ``--workers 2``): worker threads
  load the next batches, and copy them to the device while the current
  step runs;
* host-fed and synchronous (``--workers 0``);
* ``--device-cache``: the dataset is pinned on the device under
  ``--cache-codec`` and every step gathers and decodes its batch there.
  With the raw codec the cache build also precomputes WB, GC and CLAHE
  of every dihedral augmentation variant (the CLAHE kernels, one launch
  per chunk of items), so the steps run no classical transform
  (``--no-precache-histeq`` keeps them in the step); ``--precache-vgg-ref``
  also precomputes the perceptual term's reference features.

By default (``--device-preprocess``) the host ships raw uint8 pairs and
augment + WB/GC/CLAHE run in the step, on the CLAHE kernels;
``--host-preprocess`` runs cv2's WB/GC/CLAHE on the host and ships the five
float32 views (ten times the bytes). Each run writes
``<train-root>/<n>/{last.npz, metrics-train.csv, metrics-val.csv,
summary.json, config.json}``; ``last.npz`` is in the JAX package's layout,
so either package loads it. Per epoch it prints the JAX CLI's lines and
one ``epoch_stats {...}`` JSON line: images/s, step ms (the device
synchronised at the epoch's end), peak device memory, each kernel's
launches in the train and val passes and, host-fed, the ``pipeline_*``
keys (stall pct, per-stage ms, transfer bytes per batch). With
``--device-cache`` a ``cache_build {...}`` JSON line comes first: the
build's seconds, resident bytes and kernel launches. The last JSON line,
``final_state {...}``, names the process and the SHA-256 of its final
parameters.

Fault tolerance, as in the JAX CLI: every epoch writes ``state/`` (the
full train state: parameters, Adam moments, the schedule's position, the
step) and a managed checkpoint under ``checkpoints/step-<n>/`` with the
resume metadata (``--keep-checkpoints`` bounds them: the newest N plus
the best val PSNR). SIGTERM/SIGINT checkpoint the run at the next step
boundary with its exact position, so ``--resume auto`` (the newest good
checkpoint across the run dirs under ``--train-root``, falling back past
truncated ones) continues it bit for bit; ``--resume DIR`` restores one
``state/`` directory. ``--checkpoint-every`` adds mid-epoch checkpoints;
``--nan-guard`` contains a non-finite step by rollback and replay without
the bad batch; ``--heartbeat-dir`` writes liveness records;
``WATERNET_FAULTS`` (e.g. ``nan@3,sigterm@10``) injects faults for fire
drills. ``--perf-csv`` appends the windowed ``mfu_live`` and
``hbm_peak_bytes`` columns to ``metrics-train.csv``; ``--profile-dir``
writes a ``torch.profiler`` Chrome trace of the first warm epoch;
``--debug-nans`` stops at the first operation that makes a NaN. The port
reads no JAX Orbax state: JAX state crosses over through
``utils/convert.py::train_state_from_jax``.

``--distill`` trains the fast tier's CAN student (``--student-width``,
``--student-depth``) against the frozen WaterNet teacher of
``--teacher-weights``: the teacher runs in the step on the WB/GC/CLAHE
planes, its output replaces the reference in every loss and metric, and
``last.npz`` is the student (what ``--student-weights`` serves).

Multi-GPU, as the JAX CLI: ``--spatial-shards N`` splits each image's
height over the process's N devices (``parallel/spatial.py``). Under the
supervisor (``python -m waternet_tpu_torch.resilience.supervisor``) the
``WATERNET_*`` env contract joins the process to a ``torch.distributed``
group (``parallel/distributed.py``; NCCL on CUDA, gloo on the CPU or
under ``WATERNET_CPU_GLOO``) and each process trains one data shard under
``DistributedDataParallel``, on its own card (process r owns cards ``[r*N,
(r+1)*N)``). Only process 0 writes the CSVs, the weights, the
checkpoints, ``config.json`` (with ``num_processes`` and
``restart_generation``) and TensorBoard; every process heartbeats. A
time-based ``--checkpoint-every`` is refused multi-process (the clocks
differ, the save point must not). ``--tensorboard`` writes the JAX CLI's
scalars (``train/<k>``, ``val/<k>``, ``perf/images_per_sec`` at step =
epoch) to ``<run>/tb`` through ``torch.utils.tensorboard``.

Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

_REPO_ROOT = Path(__file__).resolve().parent.parent


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--epochs", type=int, default=400, help="Number of epochs (default 400).")
    p.add_argument("--batch-size", type=int, default=16, help="Batch size (default 16).")
    p.add_argument("--height", type=int, default=112, help="Image height (default 112).")
    p.add_argument("--width", type=int, default=112, help="Image width (default 112).")
    p.add_argument("--weights", help="Starting weights: .npz (JAX layout) or the reference's .pt.")
    p.add_argument("--seed", type=int, default=0, help="Seed (default 0).")
    p.add_argument("--val-size", type=int, default=90, help="Validation split size (default 90).")
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"],
                   help="Model/VGG compute dtype; parameters stay fp32 (default bf16).")
    p.add_argument("--spatial-shards", type=int, default=1,
                   help="Shard image height over N devices during training (for resolutions whose "
                   "activations exceed one card); this process's N cards, or N shares of one card under "
                   "WATERNET_CPU_GLOO.")
    p.add_argument("--vgg-weights", help="VGG19 weights for the perceptual loss (.npz JAX layout, or torchvision .pt).")
    p.add_argument("--no-perceptual", action="store_true", help="Drop the VGG perceptual term.")
    p.add_argument("--data-root", default="data", help="UIEB root holding raw-890/ and reference-890/ (default data).")
    p.add_argument("--host-preprocess", action="store_true",
                   help="cv2/NumPy WB+GC+CLAHE on the host: the feed ships five float32 views per batch.")
    p.add_argument("--device-preprocess", action="store_true",
                   help="Name the default mode: the feed ships raw uint8 pairs and augment + WB/GC/CLAHE run in the "
                   "step, on the CLAHE kernels. Conflicts with --host-preprocess.")
    p.add_argument("--workers", type=int, default=2, metavar="N",
                   help="Host-fed: N worker threads load (and host-preprocess) batches and copy them to the device "
                   "ahead of the step, bit for bit the synchronous epoch; 0 = synchronous (default 2).")
    p.add_argument("--prefetch", type=int, default=0, metavar="K",
                   help="Batches in flight in the input pipeline (default 0 = 2x workers).")
    p.add_argument("--device-cache", action="store_true",
                   help="Pin the dataset on the device and gather batches there.")
    p.add_argument("--cache-codec", default="raw", choices=["raw", "yuv420", "dct8", "auto"],
                   help="Codec of the device cache: raw (1x), yuv420 (2x), dct8 (4x, decoded by a CUDA kernel in the step), "
                   "or auto (the budgeter picks the cheapest decode that fits).")
    p.add_argument("--cache-report", action="store_true",
                   help="Print the device-cache budget table for this dataset and size, and exit.")
    p.add_argument("--no-precache-histeq", action="store_true",
                   help="With --device-cache: keep WB/GC/CLAHE inside the step instead of precomputing them (CLAHE per "
                   "dihedral augmentation variant) at cache-build time.")
    p.add_argument("--precache-vgg-ref", action="store_true",
                   help="With --device-cache: also precompute the perceptual term's VGG features of every dihedral ref "
                   "variant at cache-build time (the ref branch carries no gradient), so the step runs no VGG forward "
                   "on the reference. Needs the raw codec, the histeq precache and the perceptual term; numerics "
                   "equal the in-step term within float tolerance.")
    p.add_argument("--no-shuffle", action="store_true", help="No train shuffling.")
    p.add_argument("--no-augment", action="store_true", help="No flips/rot90 augmentation.")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="Train on N synthetic pairs instead of reading --data-root.")
    p.add_argument("--train-root", help="Base directory of the numbered run directories (default: training/ at the repository root).")
    p.add_argument("--resume", metavar="DIR|auto",
                   help="A state/ directory to resume from (parameters, Adam moments, schedule, step), or 'auto': the "
                   "newest restorable checkpoint under --train-root, falling back past corrupt ones, at its exact "
                   "position.")
    p.add_argument("--checkpoint-every", metavar="N|Ns|Nm",
                   help="Mid-epoch checkpoints every N steps, or every N seconds/minutes (300s, 10m). Epoch-end "
                   "checkpoints always happen.")
    p.add_argument("--keep-checkpoints", type=int, default=3, metavar="N",
                   help="Keep the newest N checkpoints plus the best-val-PSNR one (default 3).")
    p.add_argument("--nan-guard", action="store_true",
                   help="Divergence sentinel: check the step metrics every 16 steps; on NaN/Inf roll back to the last "
                   "good state and replay without the bad batch (at most 8 an epoch).")
    p.add_argument("--heartbeat-dir", metavar="DIR",
                   help="Write liveness records (worker-000.json, replaced atomically at step boundaries, at most "
                   "once per WATERNET_HEARTBEAT_SEC) into DIR; WATERNET_HEARTBEAT_DIR sets it too.")
    p.add_argument("--perf-csv", action="store_true",
                   help="Append the windowed mfu_live and hbm_peak_bytes columns to metrics-train.csv (nan where "
                   "unmeasurable, e.g. on the CPU).")
    p.add_argument("--profile-dir", metavar="DIR",
                   help="Write a torch.profiler Chrome trace (trace.json) of the first warm epoch (epoch 2, or 1 with "
                   "--epochs 1) into DIR.")
    p.add_argument("--debug-nans", action="store_true",
                   help="Raise at the first operation whose output holds a NaN, naming it (slow; for debugging).")
    p.add_argument("--distill", action="store_true",
                   help="Distill the full quality pipeline into a compact CAN student (the fast serving tier): the "
                   "trained model becomes models/can.CANStudent mapping raw RGB directly to the frozen WaterNet "
                   "teacher's output; every loss and metric (the val ssim/psnr columns too) reads as "
                   "student-against-teacher fidelity. --weights still names the TRAINED model's starting weights.")
    p.add_argument("--teacher-weights",
                   help="Frozen teacher checkpoint for --distill (.npz or the reference's .pt); defaults to the "
                   "standard weight resolution (WATERNET_TPU_WEIGHTS, ./weights).")
    p.add_argument("--student-width", type=int, default=24, help="--distill: CAN student channel width (default 24).")
    p.add_argument("--student-depth", type=int, default=7,
                   help="--distill: CAN student 3x3 stage count (default 7; dilations 1,2,...,2^(depth-2),1).")
    p.add_argument("--tensorboard", action="store_true",
                   help="Write the epoch scalars (train/<k>, val/<k>, perf/images_per_sec at step = epoch) to "
                   "<run>/tb with torch.utils.tensorboard (needs the tensorboard package).")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'.")
    args = p.parse_args(argv)
    if args.tensorboard:
        try:
            import tensorboard  # noqa: F401 - torch.utils.tensorboard writes through it
        except ImportError:
            p.error("--tensorboard needs the 'tensorboard' package, which is not importable here")
    if args.spatial_shards < 1:
        p.error("--spatial-shards must be >= 1")
    if args.distill and args.spatial_shards > 1:
        p.error("--distill supports data parallelism only for now (the student's dilated convs would need "
                "64-row spatial halos)")
    if args.device_preprocess and args.host_preprocess:
        p.error(
            "--device-preprocess and --host-preprocess are mutually exclusive (device "
            "preprocessing is the default; --host-preprocess selects the cv2 host path)"
        )
    if args.cache_codec != "raw" and not (args.device_cache or args.cache_report):
        p.error("--cache-codec requires --device-cache")
    if args.device_cache and args.host_preprocess:
        p.error("--device-cache requires device preprocessing")
    if args.distill and args.precache_vgg_ref:
        p.error("--precache-vgg-ref is incompatible with --distill (the distillation target is the teacher "
                "output, not the ground-truth ref the feature table is built from)")
    if args.teacher_weights and not args.distill:
        p.error("--teacher-weights needs --distill")
    if args.precache_vgg_ref and not (args.device_cache or args.cache_report):
        # An ignored A/B flag must fail loudly, not measure the wrong path;
        # cache_dataset refuses the other combinations.
        p.error("--precache-vgg-ref requires --device-cache")
    try:
        args.every_steps, args.every_secs = parse_checkpoint_interval(args.checkpoint_every)
    except ValueError:
        p.error(f"--checkpoint-every: want N, Ns or Nm, got {args.checkpoint_every!r}")
    return args


def parse_checkpoint_interval(spec):
    """``"500"`` -> (500 steps, 0 s); ``"300s"``/``"10m"`` -> (0, seconds)."""
    if not spec:
        return 0, 0.0
    spec = spec.strip().lower()
    if spec.endswith("s"):
        return 0, float(spec[:-1])
    if spec.endswith("m"):
        return 0, float(spec[:-1]) * 60.0
    return int(spec), 0.0


#: --perf-csv's columns, after the metrics.
PERF_CSV_COLS = ("mfu_live", "hbm_peak_bytes")


def main(argv=None) -> int:
    args = parse_args(argv)
    start_ts = time.perf_counter()
    from waternet_tpu_torch.data import codec as cachecodec
    from waternet_tpu_torch.data.synthetic import SyntheticPairs, synthetic_split
    from waternet_tpu_torch.data.uieb import UIEBDataset, reference_split
    from waternet_tpu_torch.models.vgg import resolve_vgg_params
    from waternet_tpu_torch.ops import kernels
    from waternet_tpu_torch.resilience import (
        CheckpointManager,
        DivergenceSentinel,
        EpochControl,
        HeartbeatWriter,
        Preempted,
        PreemptionGuard,
        auto_resume,
    )
    from waternet_tpu_torch.resilience import faults
    from waternet_tpu_torch.training.trainer import (
        TRAIN_METRICS_NAMES,
        VAL_METRICS_NAMES,
        TrainConfig,
        TrainingEngine,
        vgg_ref_bytes_per_item,
    )
    from waternet_tpu_torch.parallel import distributed as pdist
    from waternet_tpu_torch.utils import rundir
    from waternet_tpu_torch.utils.checkpoint import save_weights
    from waternet_tpu_torch.utils.device import resolve_device

    # Multi-process bootstrap from the supervisor's env contract; a no-op
    # for a process on its own.
    multi = pdist.initialize(device=args.device)
    rank, world, gen = pdist.process_index(), pdist.process_count(), pdist.generation()
    writer = rank == 0  # the one process that writes the run's files
    if args.every_secs and world > 1:
        raise SystemExit(
            "time-based --checkpoint-every is not multi-process safe (process clocks differ, but every "
            "process must stop at the same step); use a step count"
        )
    try:
        devices = pdist.process_devices(args.device, args.spatial_shards, rank)
    except ValueError as e:
        raise SystemExit(f"--spatial-shards {args.spatial_shards}: {e}")
    dev = resolve_device(devices[0])
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
    if multi:
        print(f"Multi-process: process {rank}/{world} (generation {gen}) on {[str(d) for d in devices]}",
              flush=True)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    # Deterministic fault injection for fire drills and tests
    # (WATERNET_FAULTS="nan@3,sigterm@10"); nothing without the variable.
    faults.install_from_env()
    # Liveness records (--heartbeat-dir or WATERNET_HEARTBEAT_DIR); the
    # startup beat comes before the data and the model are set up.
    heartbeat = HeartbeatWriter.resolve(args.heartbeat_dir, process_id=rank, generation=gen)
    if heartbeat is not None:
        heartbeat.beat(step=0, phase="startup", force=True)

    config = TrainConfig(
        epochs=args.epochs,
        batch_size=args.batch_size,
        im_height=args.height,
        im_width=args.width,
        precision=args.precision,
        shuffle=not args.no_shuffle,
        seed=args.seed,
        augment=not args.no_augment,
        perceptual_weight=0.0 if args.no_perceptual else 0.05,
        host_preprocess=args.host_preprocess,
        precache_histeq=not args.no_precache_histeq,
        precache_vgg_ref=args.precache_vgg_ref,
        cache_codec=args.cache_codec,
        distill=args.distill,
        student_width=args.student_width,
        student_depth=args.student_depth,
        spatial_shards=args.spatial_shards,
    )
    if args.synthetic:
        dataset = SyntheticPairs(args.synthetic, args.height, args.width, seed=args.seed)
        train_idx, val_idx = synthetic_split(len(dataset), args.val_size)
    else:
        root = Path(args.data_root)
        dataset = UIEBDataset(root / "raw-890", root / "reference-890", im_height=args.height, im_width=args.width)
        train_idx, val_idx = reference_split(len(dataset), n_val=args.val_size)
        # Decode every pair up front: corrupt pairs are quarantined before
        # the batches are composed (the RAM cache pays this cost anyway).
        train_idx = dataset.prevalidate(train_idx)
        val_idx = dataset.prevalidate(val_idx)

    if args.cache_report:
        headroom = cachecodec.resolve_headroom(dev)
        rows = cachecodec.budget_report(
            len(train_idx), args.height, args.width, headroom=headroom,
            precache_histeq=config.precache_histeq,
            precache_vgg_ref=config.precache_vgg_ref,
            vgg_ref_bytes_per_item=vgg_ref_bytes_per_item(args.height, args.width, args.precision),
        )
        for line in cachecodec.report_lines(rows, headroom):
            print(line)
        return 0

    params = None
    if args.weights:
        from waternet_tpu_torch.hub import resolve_weights

        params = resolve_weights(args.weights)
    vgg_params = None if args.no_perceptual else resolve_vgg_params(args.vgg_weights)
    teacher_params = None
    if args.distill:
        from waternet_tpu_torch.hub import resolve_weights

        teacher_params = resolve_weights(args.teacher_weights)
        if teacher_params is None:
            raise SystemExit(
                "--distill needs frozen teacher weights: pass --teacher-weights, set "
                "WATERNET_TPU_WEIGHTS, or place the teacher checkpoint in ./weights"
            )
    engine = TrainingEngine(config, params=params, vgg_params=vgg_params, device=dev,
                            teacher_params=teacher_params,
                            devices=devices if args.spatial_shards > 1 else None)

    saved_train = {k: [] for k in TRAIN_METRICS_NAMES}
    saved_val = {k: [] for k in VAL_METRICS_NAMES}
    # --perf-csv: one row per epoch this process trained, aligned to the
    # tail of saved_train when the CSV is written (a resumed history has
    # no perf for the epochs an earlier process trained: those rows read nan).
    saved_perf = {k: [] for k in PERF_CSV_COLS}
    start_epoch, start_batch, carry = 0, 0, None
    train_root = Path(args.train_root) if args.train_root else _REPO_ROOT / "training"
    if args.resume == "auto":
        meta = auto_resume(engine, train_root)
        if meta is None:
            print("No previous run state found; starting fresh")
        else:
            # A managed checkpoint carries the exact position and the metric
            # history; a bare state/ directory (meta {}) neither.
            start_epoch = int(meta.get("epoch", 0))
            start_batch = int(meta.get("batch_index", 0))
            carry = meta.get("partial_metrics") or None
            for k, vals in (meta.get("history_train") or {}).items():
                saved_train[k] = list(vals)
            for k, vals in (meta.get("history_val") or {}).items():
                saved_val[k] = list(vals)
            if start_epoch or start_batch:
                print(f"Resuming at epoch {start_epoch + 1}, batch {start_batch}")
    elif args.resume:
        engine.restore(args.resume)

    if args.device_cache:
        kernels.reset_launches()
        sync()
        t0 = time.perf_counter()
        try:
            engine.cache_dataset(dataset, train_idx)
        except ValueError as e:  # the cache's rules, e.g. what --precache-vgg-ref needs
            raise SystemExit(f"--device-cache: {e}")
        sync()
        _record("cache_build", {
            "cache_build_sec": time.perf_counter() - t0, "cache_codec": engine.config.cache_codec,
            "hbm_cache_bytes": engine.cache_resident_bytes(),
            "precache_histeq": engine._cache_pre is not None,
            "precache_vgg_ref": engine._cache_pre is not None and engine._cache_pre["vgg_ref"] is not None,
            "launches": dict(kernels.LAUNCHES),
        })
        print(
            f"Device cache: codec={engine.config.cache_codec} "
            f"resident={engine.cache_resident_bytes()} bytes "
            f"({len(train_idx)} pairs at {args.height}x{args.width})",
            flush=True,
        )

    def train_epoch(epoch, sb, control, carry):
        start_items = min(sb * config.batch_size, len(train_idx))
        if args.device_cache:
            return engine.train_epoch_cached(epoch, start_batch=sb, control=control, carry=carry)
        if args.workers > 0:
            return engine.train_epoch_pipelined(
                dataset, train_idx, epoch, workers=args.workers, prefetch=args.prefetch,
                start_batch=sb, start_items=start_items, control=control, carry=carry,
            )
        batches = dataset.batches(
            train_idx, config.batch_size, shuffle=config.shuffle, seed=config.seed, epoch=epoch, start=sb
        )
        return engine.train_epoch(batches, epoch, start_batch=sb, start_items=start_items,
                                  control=control, carry=carry)

    def val_epoch():
        if args.device_cache:
            return engine.eval_epoch_cached(dataset=dataset, indices=val_idx)
        if args.workers > 0:
            return engine.eval_epoch_pipelined(dataset, val_idx, workers=args.workers, prefetch=args.prefetch)
        return engine.eval_epoch(dataset.batches(val_idx, config.batch_size, shuffle=False))

    def midepoch_meta(epoch, next_batch, partial):
        return {"epoch": epoch, "batch_index": next_batch, "partial_metrics": partial,
                "history_train": saved_train, "history_val": saved_val}

    savedir = rundir.next_run_dir(train_root)
    if multi:
        # Every process names the same run directory before any creates it.
        torch.distributed.barrier()
    manager = CheckpointManager(savedir / "checkpoints", keep=args.keep_checkpoints)

    def save_checkpoint(meta):
        if writer:
            manager.save(engine, meta=meta)

    tb_writer = None
    if args.tensorboard and writer:
        from torch.utils.tensorboard import SummaryWriter

        tb_writer = SummaryWriter(str(savedir / "tb"))
    throughputs = []
    n_steps = -(-len(train_idx) // config.batch_size)
    profile_epoch = min(1, args.epochs - 1)  # the first warm epoch
    guard = PreemptionGuard()
    with guard, _debug_nans(args.debug_nans):
        for epoch in range(start_epoch, args.epochs):
            sb = start_batch if epoch == start_epoch else 0
            profiler = (_start_profiler(cuda) if args.profile_dir and writer and epoch == profile_epoch
                        else None)
            if heartbeat is not None:
                heartbeat.epoch = epoch
            control = EpochControl(
                preemption=guard,
                sentinel=DivergenceSentinel() if args.nan_guard else None,
                checkpoint_cb=lambda nb, pm, _e=epoch: save_checkpoint(midepoch_meta(_e, nb, pm)),
                every_steps=args.every_steps,
                every_secs=args.every_secs,
                heartbeat=heartbeat,
            )
            if cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            kernels.reset_launches()
            sync()
            t0 = time.perf_counter()
            try:
                train_metrics = train_epoch(epoch, sb, control, carry if epoch == start_epoch else None)
            except Preempted as pre:
                save_checkpoint(midepoch_meta(epoch, pre.next_batch, pre.partial))
                if profiler is not None:
                    profiler.stop()
                if heartbeat is not None:
                    heartbeat.beat(step=engine._host_step, phase="preempted", force=True)
                print(f"Preempted at epoch {epoch + 1}, batch {pre.next_batch}; checkpoint saved. "
                      "Resume with --resume auto.", flush=True)
                return 0
            sync()
            train_dt = time.perf_counter() - t0
            train_launches = dict(kernels.LAUNCHES)
            if heartbeat is not None:
                # Val and the epoch-end checkpoints beat no steps: anchor the
                # hang detector here.
                heartbeat.beat(step=engine._host_step, phase="val", force=True)
            kernels.reset_launches()
            val_metrics = val_epoch()
            sync()
            dt = time.perf_counter() - t0
            val_launches = dict(kernels.LAUNCHES)
            if profiler is not None:
                profiler.stop()
                Path(args.profile_dir).mkdir(parents=True, exist_ok=True)
                profiler.export_chrome_trace(str(Path(args.profile_dir) / "trace.json"))
            # A resumed partial epoch trained only its tail: count that.
            steps = n_steps - sb
            trained = len(train_idx) - min(sb * config.batch_size, len(train_idx))
            ips = trained / train_dt
            throughputs.append(ips)
            print(
                f"Epoch {epoch + 1}/{args.epochs} "
                f"[train {train_dt:.1f}s + val {dt - train_dt:.1f}s, {ips:.1f} img/s]"
            )
            print("    Train ||", "   ".join(f"{k}: {v:.03g}" for k, v in train_metrics.items()))
            print("    Val   ||", "   ".join(f"{k}: {v:.03g}" for k, v in val_metrics.items()))
            _record("epoch_stats", {
                "epoch": epoch + 1, "device": str(dev), "process": rank, "train_images": trained,
                "steps": steps, "train_s": train_dt, "val_s": dt - train_dt,
                "train_images_per_s": ips, "step_ms": train_dt / max(steps, 1) * 1e3,
                "peak_mem_bytes": torch.cuda.max_memory_allocated(dev) if cuda else None,
                "train": {k: train_metrics[k] for k in TRAIN_METRICS_NAMES},
                "val": {k: val_metrics[k] for k in VAL_METRICS_NAMES},
                **{k: v for k, v in train_metrics.items() if k.startswith(("pipeline_", "nan_"))},
                "val_pipeline": {k: v for k, v in val_metrics.items() if k.startswith("pipeline_")},
                "launches": {"train": train_launches, "val": val_launches},
            })
            for k in TRAIN_METRICS_NAMES:
                saved_train[k].append(train_metrics[k])
            for k in VAL_METRICS_NAMES:
                saved_val[k].append(val_metrics[k])
            if args.perf_csv:
                snap = engine.perf.epoch_snapshot()
                for k in PERF_CSV_COLS:
                    saved_perf[k].append(np.nan if snap[k] is None else float(snap[k]))
            if tb_writer is not None:
                for k, v in train_metrics.items():
                    if isinstance(v, (int, float)):
                        tb_writer.add_scalar(f"train/{k}", v, epoch)
                for k, v in val_metrics.items():
                    if isinstance(v, (int, float)):
                        tb_writer.add_scalar(f"val/{k}", v, epoch)
                tb_writer.add_scalar("perf/images_per_sec", ips, epoch)
                tb_writer.flush()  # an abnormal exit keeps the epoch
            if writer:
                savedir.mkdir(parents=True, exist_ok=True)
                save_weights(engine.model.state_dict(), savedir / "last.npz")
                engine.checkpoint(savedir / "state")
            # The managed checkpoint: atomic, marker-finalized, with the
            # position and history a bit-for-bit --resume auto needs.
            save_checkpoint({
                "epoch": epoch + 1, "batch_index": 0, "history_train": saved_train,
                "history_val": saved_val, "val_psnr": float(val_metrics["psnr"]),
            })
            if heartbeat is not None:
                heartbeat.beat(step=engine._host_step, phase="epoch-end", force=True)
            if guard.requested:
                # The signal came during val or the checkpoints: the
                # epoch-end checkpoint above holds everything.
                print(f"Preempted after epoch {epoch + 1}; checkpoint saved. Resume with --resume auto.", flush=True)
                return 0

    if heartbeat is not None:
        heartbeat.beat(step=engine._host_step, phase="done", force=True)
    # Every process names its final parameters: data-parallel ranks end equal.
    _record("final_state", {"process": rank, "num_processes": world, "step": engine._host_step,
                            "params_sha256": _params_digest(engine.model.state_dict())})
    if tb_writer is not None:
        tb_writer.close()
    pdist.shutdown()
    if not writer:
        return 0
    savedir.mkdir(parents=True, exist_ok=True)
    train_arr = np.array([saved_train[k] for k in TRAIN_METRICS_NAMES], dtype=np.float64).T.reshape(
        -1, len(TRAIN_METRICS_NAMES))
    train_header = list(TRAIN_METRICS_NAMES)
    if args.perf_csv and train_arr.size:
        n = train_arr.shape[0]
        cols = []
        for k in PERF_CSV_COLS:
            col = np.full(n, np.nan)
            vals = saved_perf[k][-n:]
            if vals:
                col[n - len(vals):] = vals
            cols.append(col)
        train_arr = np.concatenate([train_arr, np.stack(cols, 1)], 1)
        train_header += list(PERF_CSV_COLS)
    val_arr = np.array([saved_val[k] for k in VAL_METRICS_NAMES], dtype=np.float64).T.reshape(
        -1, len(VAL_METRICS_NAMES))
    for name, arr, header in (("metrics-train.csv", train_arr, train_header),
                              ("metrics-val.csv", val_arr, VAL_METRICS_NAMES)):
        np.savetxt(savedir / name, arr, fmt="%f", delimiter=",", comments="", header=",".join(header))
    summary = {"epochs": len(throughputs), "wall_time_sec": time.perf_counter() - start_ts}
    if throughputs:
        summary["train_images_per_sec_mean"] = float(np.mean(throughputs))
        summary["train_images_per_sec_last"] = float(throughputs[-1])
    (savedir / "summary.json").write_text(json.dumps(summary, indent=4))
    (savedir / "config.json").write_text(json.dumps({
        "epochs": args.epochs,
        "batch_size": args.batch_size,
        "im_height": args.height,
        "im_width": args.width,
        "weights": args.weights,
        "precision": args.precision,
        "shuffle": config.shuffle,
        "augment": config.augment,
        "device_preprocess": not config.host_preprocess,
        "device": str(dev),
        "cache_codec": engine.config.cache_codec if args.device_cache else None,
        "precache_histeq": config.precache_histeq,
        "precache_vgg_ref": config.precache_vgg_ref,
        "cache_resident_bytes": engine.cache_resident_bytes(),
        "distill": config.distill,
        "student_width": config.student_width if config.distill else None,
        "student_depth": config.student_depth if config.distill else None,
        "spatial_shards": config.spatial_shards,
        # Supervision provenance: which restart generation finished the
        # run, and over how many processes.
        "restart_generation": gen,
        "num_processes": world,
    }, indent=4))
    print(f"Metrics and weights saved to {savedir}")
    print(f"Total time: {time.perf_counter() - start_ts}s")
    return 0


def _record(tag: str, obj: dict) -> None:
    """One ``<tag> {json}`` line in a single write, so ranks that share a
    pipe never split it, even unbuffered (``print`` writes its newline
    separately there)."""
    sys.stdout.write(f"{tag} {json.dumps(obj)}\n")
    sys.stdout.flush()


def _params_digest(state_dict) -> str:
    """SHA-256 of a state_dict's tensors' bytes, in key order."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(state_dict):
        h.update(k.encode())
        h.update(state_dict[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _start_profiler(cuda: bool):
    """A started ``torch.profiler`` over the host and, on CUDA, the card."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _debug_nans(on: bool):
    """``--debug-nans``: the NaN-checking dispatch mode, or nothing."""
    if not on:
        return contextlib.nullcontext()
    from waternet_tpu_torch.utils.debug_nans import NanCheckMode

    return NanCheckMode()


if __name__ == "__main__":
    sys.exit(main())
