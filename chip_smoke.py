#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``waternet_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py            # from the repository root; needs 1 card

Phases; any failure exits non-zero, and nothing below is caught:

1. the card's name and power limit (nvidia-smi), and the TF32 switches;
2. build every kernel from ``waternet_tpu_torch/csrc`` with nvcc (one
   process per source, in parallel, linked into one library);
3. the time of the smallest launch (a 4-byte fill), then the CLAHE
   kernels against their plain PyTorch versions on the card, bit for bit,
   at the inference shape (4 x 1080x1920, 16-byte loads, one CTA per
   tile), an odd one (1 x 723x1001, padded 728x1008: 2-byte loads,
   clusters of 4 CTAs per tile), a tiny one (2 x 37x53, padded 40x56:
   1-byte loads), and the L planes of T1's and T2's first train batch as
   their steps make them (8 x 256x256 from the dct8 cache, 32x32 tiles,
   16-byte loads; 16 x 112x112 from the raw cache, 14x14 tiles, 2-byte
   loads), and the L planes of the oversize frames S2 and St(b) send
   (1 x 1094x1455 each, 8 px a side past phase 12's largest bucket: the
   native fallback's input), with each tile kernel's launch plan (cluster size K, vector
   width), their times, the plain versions' times, the one-call PyTorch
   yardstick where there is one, and their bounds; ``tile_lut`` also
   under every K in {1, 2, 4, 8} at the first two shapes, bit for bit,
   with its time at each; ``clahe_lut_blend`` (the lookup with CLAHE's
   blend, rounding and crop fused, the main path's launch) against its
   plain version and against the path it replaced (the f32 planes kernel,
   then the eager blend), with both interpolation kernels' strip plans,
   and at the inference shape its time on a constant and on a uniform
   random plane (what the shared-memory gathers' bank conflicts cost);
4. CLAHE through the kernels against the plain CLAHE, bit for bit, at
   the same seven planes;
5. the inference path, ``InferenceEngine(device_preprocess=True)`` on
   CUDA with the committed trained weights, answering R1 (4 x 1080x1920,
   batched 1080p video frames), R2 (1 x 723x1001) and R3 (2 x 251x333),
   with the CLAHE kernels' launch counters read around that run; R3 again
   on the CPU port, which must agree within one uint8 level;
6. the two kernels of the training slice against their plain versions,
   bit for bit: ``dct8_dequant_idct`` (f32 blocks) and ``dct8_decode_u8``
   (the whole decode to cropped uint8 images, which must also equal the
   f32 kernel followed by the eager-torch epilogue it replaced) at NB =
   49,152 (the T1 step's one launch: raw and ref of 8 x 256x256 decoded
   together), 24,576 (one side), an odd 1,989 (3 x 104x136) and a cropped
   1,326 (2 x 100x130); ``tile_histogram`` at the five L planes of phase
   3, where ``luts_from_hist(tile_histogram(l))`` must also equal
   ``tile_lut(l)``; with the same timings as phase 3, and for the decode
   also the replaced path's time;
7. training on the card from ``SyntheticPairs(seed=0)``, perceptual loss
   on, each epoch's launches read around it:
   T1 ``python -m waternet_tpu_torch.train`` as a subprocess, dct8 device
   cache, 8 x 256x256, 64 pairs (56 train / 8 val), 2 epochs, fp32, then
   the same in bf16 (its raw val cache has identity-variant precache
   tables, built in the first val pass: one launch of each CLAHE kernel,
   none in the val steps); T2 ``TrainingEngine`` directly, raw cache with WB/GC/
   CLAHE in the step, 16 x 112x112, 64 pairs, 2 epochs (the first holds
   the first-call setup: cuDNN plans, lazy kernel loading), fp32; T3 one dct8
   train step at 4 x 64x64, fp32, no augmentation, on the card and on the
   CPU port from the same parameters and batch;
8. T4, host-fed training at the JAX CLI's default config (16 x 112x112,
   bf16, perceptual on, device preprocessing) through ``python -m
   waternet_tpu_torch.train``: 144 synthetic pairs (8 train steps and one
   val step an epoch), 2 epochs with ``--workers 2``, then the cached raw
   path at the same size and precision, through ``TrainingEngine`` in
   this process (no process start-up), as the same-call yardstick; per
   warm epoch images/s, step ms, the pipeline's stall pct, per-stage ms
   and transfer bytes (two uint8 tensors a batch, 1,204,224 bytes), peak
   memory and launches (one ``tile_lut`` and one ``clahe_lut_planes`` per
   train and val step, none of the other two). Then, side by side: a
   UIEB-layout tree written with cv2 at 128x160, one epoch trained from
   ``--data-root`` on device preprocessing (resized to 112x112 on load;
   T4's launches and bytes a step); one ``--host-preprocess`` epoch of 128
   synthetic pairs (five float32 views, 12,042,240 bytes a batch; no
   kernel launches: cv2 runs CLAHE on the host); ``python -m
   waternet_tpu_torch.score`` in its paired and no-reference modes on the
   tree, with finite metrics; meanwhile, on
   ``TrainingEngine`` directly at fp32 with cuDNN's deterministic
   algorithms, 4 steps of 16 x 112x112 host-fed with 2 and 0 workers
   against the cached raw path: the network's five input views of every
   step and the step's metrics, bit for bit;
9. T5, the precache tables (``--device-cache``'s default with the raw
   codec) at T4's config: ``python -m waternet_tpu_torch.train
   --device-cache`` (64 pairs, 2 epochs, bf16), then with
   ``--precache-vgg-ref``: the table build launches each CLAHE kernel
   once per chunk (4 train chunks of 8 variants x 16 items, 1 val chunk),
   the precached train and val steps none; the warm step ms, the build's
   seconds, the resident bytes (exactly the budgeter's estimate) and peak
   memory. Then, on ``TrainingEngine`` at fp32 with cuDNN's deterministic
   algorithms, 4 precached steps of 16 x 112x112 against 4 in-step
   raw-cache steps: the five input views and the metrics bit for bit; the
   card's WB/GC tables equal to the CPU port's, its CLAHE table within
   one level (the share printed); ``precache_vgg_ref``'s epoch within rel
   1e-4, abs 1e-6 of the in-step one. Then ``python -m
   waternet_tpu_torch.bench`` at its defaults and with ``--config
   train_fullres``: each exits 0 and ends in its contract line with a
   finite positive value and ``mfu`` in (0, 1];
10. V, video: cv2's video I/O probed (a writer of each fourcc, avc1
   and mp4v, on a 1080p clip, read back; the "Video I/O" part of
   ``cv2.getBuildInformation()``); a 26-frame 1080x1920 clip panning
   over one seeded ``photo_frames`` frame, written to a temp mp4
   (mp4v where it opens, else avc1); ``enhance_video_stream`` at
   batch 4 with ``prefetch=2`` on a bf16 ``InferenceEngine(
   device_preprocess=True)``: 26 frames in order, each CLAHE kernel
   launched once per batch (7, the tail padded), the frames equal to
   ``engine.enhance`` on the same decoded, padded batches bit for bit,
   and a warm pass's frames/s. Then R1 in bf16 (p50 of 5, peak memory,
   beside phase 5's fp32 R1), a bf16 request on the card against the CPU
   port's bf16 engine (1 x 96x128, within 3 levels and more than one on at
   most 1% of values), and how long ``enhance_async`` takes to return
   while the previous R1 batch runs; ``python -m
   waternet_tpu_torch.inference`` on the clip (``--device-preprocess
   --precision bf16 --batch-size 4 --show-split --workers 2``): 26
   frames at 1920x1080 written, its ``video_ingest`` line; the flicker
   index of the input and of the enhanced clip, under the pan's true
   flow and the identity flow; ``python -m
   waternet_tpu_torch.bench --config video``, its contract line with a
   finite positive value and ``mfu`` in (0, 1];
11. R, resume and resilience, each count of launches from 0 around its
   runs: R1, T1's config (8 x 256x256 dct8 cache, 64 pairs, perceptual
   on) through ``TrainingEngine`` at fp32 with cuDNN's deterministic
   algorithms, 2 epochs of 7 steps uninterrupted, then interrupted by a
   real SIGTERM after global step 10 (``sigterm@10``, under
   ``PreemptionGuard``), checkpointed by ``CheckpointManager`` at
   (epoch 1, batch 3) and resumed in a fresh engine through
   ``auto_resume``: the final parameters, Adam moments and steps, and the
   epoch-2 metrics equal to the uninterrupted run's bit for bit, each of
   ``dct8_decode_u8``, ``tile_lut`` and ``clahe_lut_blend`` launched once
   a step in both runs, the save's and the restore's seconds and the
   state's bytes; R2, the same host-fed through ``train_epoch_pipelined``
   with 2 workers at T4's step size (16 x 112x112, 80 pairs, 5 steps an
   epoch, ``sigterm@8``), no pipeline thread left after the preemption;
   R3, one epoch of R1's config with ``nan@4`` under the default
   ``DivergenceSentinel``: one skip, one rollback, finite parameters, and
   13 launches of each kernel (7 dispatched steps, then the 6 good ones
   replayed from the epoch-start snapshot); R4, ``python -m
   waternet_tpu_torch.train`` at T4's bf16 config with
   ``--heartbeat-dir``, ``--perf-csv`` and ``--profile-dir``,
   uninterrupted and, side by side, with ``WATERNET_FAULTS=sigterm@10``,
   then again with ``--resume auto``, all three beside R1-R3: the
   resumed run ends at the uninterrupted run's
   step (16), every heartbeat's last record names its end (``done``,
   ``preempted``), the metrics are finite, ``mfu_live`` is in (0, 1] and
   ``hbm_peak_bytes`` > 0, and the resumed epoch's Chrome trace names
   ``clahe_tile_lut_kernel`` and ``clahe_lut_blend_kernel``;
12. S, serving (``waternet_tpu_torch/serving/``) on 24 images, each of
   its own shape (the bench's ``_serving_population(24, 540)``: ~540x720,
   ~810x1080 and ~1080x1440, plus jitter), ``teacher.npz``, the ladder
   ``derive_buckets(..., max_buckets=3)``, 4 slots a batch. S1, fp32 with
   host preprocessing: an in-process ``ServingServer`` on
   ``127.0.0.1:0`` driven by ``run_load`` at concurrency 8, each kernel's
   launches counted from 0 around the run (none: the bucketed path runs
   no kernel); every response byte-equal to ``enhance_padded`` on the
   same engine, ``compiles`` 3 with no cold dispatch; the interior
   (farther than 13 px from the pad seam) against ``engine.enhance`` at
   the native shape, its max difference and share printed, and the seam
   band's PSNR; warmup, images/s, p50/p99, occupancy, padding overhead
   and the serving trace's per-request spans (median and mean ms of
   decode, queue wait, coalesce, launch, device, d2h, response write). S2, bf16 with ``--device-preprocess``: the masked
   transforms' native regions bit for bit against ``transform_batch``
   (the CUDA CLAHE kernels) at 4 shapes; the 24 requests and one
   oversize request (larger than every bucket, served at its native
   shape through ``enhance_async``), the launches counted from 0 around
   them (one ``tile_lut``, one ``clahe_lut_blend``: the fallback's); the
   answers within 3 levels of S1's (more than one on at most 1%) beyond
   13 px from the pad seam, the seam band's gap printed (there the two
   paths pad differently by design). S3,
   ``replica_crash@1`` and ``nan_output@1`` on a 1-replica pool over one
   batch of 4: the answers byte-equal to S1's, the pool's counters
   equal to the same plan's on the CPU port. Then ``python -m
   waternet_tpu_torch.bench --config serve`` and ``--config serve_http``
   at their defaults;
13. F, the fast tier. F1: the default 24 x 7 CAN student (seeded init)
   through ``StudentEngine`` at R1 in fp32 and bf16 (p50 of 5, frames/s,
   peak memory, no launch), and the committed distilled student (24 x 5)
   at R3 on the card against the CPU port (fp32 within 2e-5, uint8 within
   one level). F2: static int8: ``InferenceEngine(quantize=True,
   device_preprocess=True)`` at R3 with the CPU port's qtree, every one of
   the 17 convolutions' int32 accumulators equal to the CPU port's on the
   same inputs (the int8 model's ``acc_hook``), the answers within one level
   of the CPU port's int8 engine, one launch of each CLAHE kernel; F2b: both
   int8 engines built for the card (not given the CPU port's qtree; they
   calibrate on the host): every conv's input scale equal to the CPU
   port's, the answers at R3 within one level, the student's int32
   accumulators equal, and each engine's build seconds; the
   int8 quality and student engines at R1 (time, peak memory, the widest
   layer's im2col band). F3: ``python -m waternet_tpu_torch.train
   --distill --teacher-weights teacher.npz`` at 16 x 112x112 bf16 with
   device preprocessing and the perceptual term, 64 pairs, 2 epochs: the
   train loss falls, one launch of each CLAHE kernel a train and val step
   (the teacher's in-step CLAHE), the warm images/s and ``mfu``, and the
   ``last.npz`` served by ``StudentEngine``. F4: phase 12's population
   through a two-tier ``ServingServer`` (teacher fp32 with host
   preprocessing, the distilled student fp32): ``compiles`` 6 with no cold
   dispatch and no launch, every ``X-Tier: fast`` answer byte-equal to
   ``enhance_padded``, each tier's images/s; then ``POST /admin/policy
   {"downgrade_watermark": 1}`` with the quality queue held full: every
   opted-in quality request answered by the fast tier (``X-Tier-Served:
   fast``), byte-equal to its answer. F5: the student's float and int8
   artifacts and WaterNet's float one through ``save_artifact`` and
   ``load_artifact`` on the card, at R3 and R2, bit for bit the eager
   forward. F6: ``bench --config tiers`` and ``WATERNET_QUANT=1 bench
   --config video`` (8 timed calls), side by side;
14. St, stream sessions and the fleet. One ``ServingServer`` over
   phase 12's ladder: the bf16 quality engine with device preprocessing,
   the fixture student (bf16) as the fast tier. (a) 3 paced ``POST
   /stream`` sessions of 24 frames (phase 12's population) at 4 frames/s
   each, traced: every frame an ``F`` record in order, byte-equal to
   ``enhance_padded``, ``compiles`` and ``cold_dispatches`` unchanged, no
   kernel launch; (b) one oversize frame: one ``tile_lut`` and one
   ``clahe_lut_blend`` (the native fallback), byte-equal to ``enhance``;
   (e) a static clip with ``X-Stream-Reuse: 0``: one ``F`` then ``R``
   records byte for byte the ``F``; (c) a ``stream_stall@1`` session
   beside a healthy paced one, whose p99 stays within its 2 s budget, and
   ``frame_corrupt@3``: one ``E`` record, at seq 2; (d) an opted-in
   stream under a held quality backlog and downgrade watermark 1: every
   frame ``FLAG_DOWNGRADED``, byte-equal to the student's
   ``enhance_padded``. (f) 2 ``python -m waternet_tpu_torch.serving.
   server`` workers on the card behind ``FleetRouter``, worker 0 with
   ``gateway_crash@1``: each worker's spawn-to-first-serve-heartbeat
   seconds and host RSS, the workers' device memory together (nvidia-smi's
   used memory before and after); the first request fails over to
   worker 1 with its ``X-Request-Id``; worker 0 comes back as generation
   1; the same upload answered byte-identically by every live worker. (g)
   ``python -m waternet_tpu_torch.obs.cli`` on (a)'s trace exits 0. (h)
   ``bench --config stream`` and ``--config serve_fleet`` at a reduced
   size, side by side, each accounted (the fleet's also byte-identical
   and recovered);
15. M, multi-GPU on one card (its shards and ranks share it). (a) R1
   through ``InferenceEngine(device_preprocess=True, spatial_shards=N,
   devices=[card] * N)`` at N = 2 and 4, fp32 and bf16: one launch of
   each CLAHE kernel a request, fp32 within one level and float atol 2e-5
   of the unsharded engine, bf16 within its 3-level bound, each R1's p50
   ms beside the unsharded one (overhead only: 26 rows computed twice a
   seam, the window copies); (b) ``data_shards=2`` at 3 R1 frames (one
   padded and cropped): within one level, 2 launches of each a request;
   (c) a spatial-2 engine behind the ``DynamicBatcher`` on phase 12's
   population (fp32, device preprocessing): its interior within one level
   of the unsharded engine's bucketed answers, no cold dispatch; (d)
   NCCL at world size 1: init, ``all_reduce``, barrier, destroy; (e)
   ``python -m waternet_tpu_torch.resilience.supervisor --workers 2
   --cpu-gloo`` at T1's fp32 config (two DDP ranks over gloo): both ranks'
   final parameters' SHA-256 equal, the CSVs within rel 1e-3 of phase 7's
   one-process T1 fp32 run, each rank's launches as T1's; beside it
   the bench's ``train_chaos`` line, in process at an 8 s hang threshold
   (recovered, 2 restarts, ``exact_resume`` printed), ``bench --config
   serve_multi`` at a reduced size (``replica_invariant`` true, one
   replica a card; with one card its ``note`` says both arms ran one
   replica) and (f) the inference CLI with ``--spatial-shards 2``, which
   exits non-zero naming the card count where fewer than 2 cards are
   visible;
16. X, the static analyzer's runtime companions (``waternet_tpu_torch/
   analysis``). (a) The lock watchdog: a ``LockTracer`` installed before
   a bf16 ``ServingServer`` with device preprocessing (bucketed
   ``DynamicBatcher``, one replica, the HTTP front door) is built; 12 of
   phase 12's population and one 6-frame stream session, no kernel
   launch; the traced lock sites and edges printed, the graph acyclic.
   (b) The sync watch: 6 steps of T2's config in bf16 through
   ``_drive_train_epoch`` without a sentinel and with one at a window of
   2, under ``torch.cuda.set_sync_debug_mode("warn")``: the synchronizing
   operations of each step with their first ``waternet_tpu_torch`` frame,
   each a site the static R003 reports, and one launch of each CLAHE
   kernel a step (``run_watchdogs`` says what the debug mode cannot see).

The last lines are the ``{"kernels": [...]}`` summary, the card line and
the ``{"ok": true, "device": ...}`` result. Inputs are made with numpy
from a seed (``waternet_tpu_torch.utils.synthetic`` and
``waternet_tpu_torch.data.synthetic``).
"""

from __future__ import annotations

import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SEED = 0
REPO = Path(__file__).resolve().parent
WEIGHTS = str(REPO / "tests" / "fixtures" / "distill" / "teacher.npz")
SOURCES = {
    "tile_lut": "waternet_tpu_torch/csrc/clahe.cu",
    "clahe_lut_planes": "waternet_tpu_torch/csrc/clahe.cu",
    "tile_histogram": "waternet_tpu_torch/csrc/clahe.cu",
    "dct8_dequant_idct": "waternet_tpu_torch/csrc/codec.cu",
}
REPLACES = {
    "tile_lut": "waternet_tpu/ops/pallas_kernels.py:133",
    "clahe_lut_planes": "waternet_tpu/ops/pallas_kernels.py:229",
    "tile_histogram": "waternet_tpu/ops/pallas_kernels.py:71",
    "dct8_dequant_idct": "waternet_tpu/ops/pallas_kernels.py:330",
}
# H100 SXM data sheet (at the full 700 W limit): 3.35 TB/s of HBM3, and
# 67 TFLOP/s float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
KERNEL_SHAPES = {"main": (4, 1080, 1920), "odd": (1, 723, 1001), "tiny": (2, 37, 53)}
REQUESTS = {"R1": (4, 1080, 1920), "R2": (1, 723, 1001), "R3": (2, 251, 333)}
# dct8 block-channel counts: the T1 step's launch, one side of it, an odd
# one, and one whose blocks the decode crops.
DCT8_SHAPES = {"main": (16, 256, 256), "half": (8, 256, 256), "odd": (3, 104, 136),
               "crop": (2, 100, 130)}
TIMING_REPS = 25
T1 = dict(synthetic=64, val_size=8, epochs=2, batch=8, hw=256)
T2 = dict(synthetic=64, val_size=8, epochs=2, batch=16, hw=112)
T3 = dict(batch=4, hw=64)
T4 = dict(synthetic=144, val_size=16, epochs=2, batch=16, hw=112, precision="bf16")
T4_EXACT = dict(pairs=64, batch=16, hw=112)  # 4 steps
T4_UIEB = dict(pairs=48, val_size=16, h=128, w=160)  # 2 train steps, 1 val step
T4_HOST = dict(synthetic=128, val_size=16)  # 7 train steps, 1 val step (the split takes n // 8)
# Launches per train or val step on the device-preprocess path, and on the
# precached one.
CLAHE_ONLY = {"tile_lut": 1, "clahe_lut_planes": 1, "tile_histogram": 0, "dct8_dequant_idct": 0}
NO_LAUNCH = dict.fromkeys(CLAHE_ONLY, 0)
# T5: the precache tables, the CLI's --device-cache default, at T4's
# config; the bit-for-bit engine check at T4_EXACT's.
T5 = dict(synthetic=64, val_size=8, epochs=2, batch=16, hw=112, precision="bf16")
# The training batches the CLAHE kernels are also held at: (batch, side, codec).
TRAIN_PLANES = {"T1": (T1["batch"], T1["hw"], "dct8"), "T2": (T2["batch"], T2["hw"], "raw")}
# V: the video clip (26 is not a multiple of 4: the tail batch is padded),
# and the shape a bf16 request is held against the CPU port's at.
# The clip pans over one seeded photo frame by (dy, dx) = pan pixels a
# frame, so the true backward flow of every frame pair is (dx, dy).
VIDEO = dict(frames=26, h=1080, w=1920, batch=4, fps=25, pan=(2, 4))
BF16_VS_CPU = (1, 96, 128)
# Phase 11 (resume and resilience). R1: T1's config through the engine
# (8 x 256x256, dct8, 7 steps an epoch), a SIGTERM after global step 10 (epoch
# 2, batch index 2: resumed at batch 3), and R3's NaN at step 4 of one epoch.
# R2: T4's step size host-fed (80 pairs: 5 steps an epoch), SIGTERM after
# step 8, also epoch 2 batch index 2. R4: T4's CLI config, SIGTERM after step
# 10 (8 steps an epoch: epoch 2, batch index 1).
RESUME_R1 = dict(synthetic=64, val_size=8, epochs=2, batch=8, hw=256, sigterm=10, nan=4)
RESUME_R2 = dict(pairs=80, epochs=2, batch=16, hw=112, workers=2, sigterm=8)
RESUME_R4 = dict(sigterm=10)
# Phase 12 (S, serving): the population, its ladder, the slots a batch and
# the load's concurrency; the S2 and S3 bounds.
SERVE = dict(n=24, base=540, max_buckets=3, max_batch=4, concurrency=8)
# The oversize frames' seeds: S2's and St(b)'s, each held in phases 3-4
# and 6 at its own L plane.
OVERSIZE_SEEDS = {"S2": SEED + 12, "St": SEED + 14}
BF16_LEVELS = 3  # the bf16 engine's bound: within 3 levels, more than 1 on <= 1%
FAULT_COUNTERS = ("requests", "retried", "nan_outputs", "quarantines", "reintegrations")
# Phase 13 (F, the fast tier): the committed distilled student (24 x 5),
# the fp32 forward's parity bound, and F3's distillation run (the JAX
# CLI's default step, 64 pairs: 56 train in 4 steps, 8 val in 1).
STUDENT = str(REPO / "tests" / "fixtures" / "distill" / "student.npz")
FAST_ATOL = 2e-5
FAST_DISTILL = dict(synthetic=64, val_size=8, batch=16, hw=112)
STREAMS = dict(streams=3, frames=24, fps=4.0, budget_ms=2000.0, stall_sec=1.0, reuse_frames=6, corrupt_at=3)
FLEET = dict(workers=2, requests=6, startup_grace_sec=300.0)
STREAM_BENCH_ENV = {"WATERNET_BENCH_SERVE_IMAGES": "12", "WATERNET_BENCH_STREAMS": "2",
                    "WATERNET_BENCH_STREAM_FRAMES": "6"}
# Three workers, as the JAX bench: its crash and hang take two of them down
# at once, and the third must answer meanwhile.
FLEET_BENCH_ENV = {"WATERNET_BENCH_FLEET_IMAGES": "8", "WATERNET_BENCH_SERVE_REQUESTS": "16"}
# Phase 15 (M, multi-GPU on one card): the spatial shard counts held at R1,
# the data shards and their odd batch, the two-rank DDP run at T1's fp32
# config and its bound against phase 7's one-process run (the dct8 bound of
# ROADMAP Queue C), and the hang threshold of the train_chaos bench that
# runs beside it (the JAX bench's 12 s default would lengthen the phase).
MULTI = dict(spatial=(2, 4), data_shards=2, data_batch=3, ddp_workers=2, ddp_rel=1e-3, chaos_hang_sec=8.0)
SERVE_MULTI_BENCH_ENV = {"WATERNET_BENCH_SERVE_IMAGES": "12"}
# Phase 16 (X, the watchdogs): (a)'s requests and stream frames from phase
# 12's population; (b)'s steps of T2's config and the sentinel's window.
WATCH = dict(requests=12, stream_frames=6, steps=6, window=2)
WATERNET_MAC_PER_PX = 1_089_824
TRAIN_KEYS = ("mse", "ssim", "psnr", "perceptual_loss", "loss")
VGG_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
           512, 512, 512, 512, "M", 512, 512, 512, 512)


def device_ms(torch, fn, flush) -> float:
    """Median device time of ``fn`` over TIMING_REPS runs after warm-up,
    by CUDA events. Each run starts with a cold L2 (``flush`` overwrites a
    buffer larger than it) behind a spin kernel long enough for the host to
    enqueue the whole run, so host overhead is not timed."""
    for _ in range(3):
        fn()
    # jaxlint: disable-next=R003 smoke check: reads the result back to compare or time it
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMING_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        flush.zero_()
        start.record()
        fn()
        end.record()
        # jaxlint: disable-next=R003 smoke check: reads the result back to compare or time it
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: int, flops: int = 0) -> tuple[float, str]:
    """(least ms the card could take, what bounds it): the larger of the
    bytes over the HBM rate and the float32 operations over their peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def step_flops(batch: int, h: int, w: int, perceptual: bool = True) -> float:
    """Estimated FLOPs of one train step: WaterNet forward and backward
    (3x the forward), and VGG19 through relu5_4 forward on the output and
    the reference plus backward to the output (3x its forward)."""
    wn = 2 * WATERNET_MAC_PER_PX * h * w
    vgg, cin, vh, vw = 0, 3, h, w
    for v in VGG_CFG:
        if v == "M":
            vh, vw = vh // 2, vw // 2
        else:
            vgg, cin = vgg + 2 * vh * vw * cin * v * 9, v
    return batch * (3 * wn + (3 * vgg if perceptual else 0))


def table_chunks(n_items: int, batch: int) -> dict:
    """Launches of one precache table build over n_items: one of each
    CLAHE kernel per chunk of ``batch`` items (all variants together)."""
    chunks = -(-n_items // min(n_items, batch))
    return {"tile_lut": chunks, "clahe_lut_planes": chunks}


def tile_keys(torch, l_pad, ty: int, tx: int):
    """Each pixel of an (N, Hp, Wp) uint8 padded L plane keyed as ``(image
    tile) * 256 + level``: one ``torch.bincount`` of these keys (with
    ``minlength`` N * ty * tx * 256) is every tile's 256-bin histogram,
    the library yardstick of the tile kernels. Built untimed."""
    n, hp, wp = l_pad.shape
    th, tw = hp // ty, wp // tx
    tile_y = torch.arange(hp, device=l_pad.device) // th
    tile_x = torch.arange(wp, device=l_pad.device) // tw
    tile = (torch.arange(n, device=l_pad.device)[:, None, None] * ty + tile_y[None, :, None]) * tx + tile_x
    return (tile * 256 + l_pad.long()).reshape(-1)


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAIL: {msg}")


def kernel_line(name, tag, shape, r, card, **extra) -> None:
    line = {
        "kernel": name, "shape": tag, **shape,
        "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
        "library_ms": r["library_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "bytes": r["bytes"],
        "max_abs_err": r["max_abs_err"], "bit_identical": True, "card": card, **extra,
    }
    print(json.dumps(line), flush=True)


def oversize_frame(seed: int) -> np.ndarray:
    """The frame S2 and St(b) send: 8 pixels a side larger than the
    largest bucket of phase 12's ladder, so the batcher serves it at its
    native shape through the CLAHE kernels."""
    from waternet_tpu_torch.bench import _serving_population
    from waternet_tpu_torch.serving import derive_buckets

    _, shapes = _serving_population(SERVE["n"], SERVE["base"])
    ladder = derive_buckets(shapes, max_buckets=SERVE["max_buckets"])
    bh = max(b[0] for b in ladder) + 8
    bw = max(b[1] for b in ladder) + 8
    return np.random.default_rng(seed).integers(0, 256, (bh, bw, 3), dtype=np.uint8)


def l_planes(torch, dev, rng) -> dict:
    """The (N, H, W) uint8 L planes the CLAHE kernels are held at: the
    inference shapes, from photo frames; the first batch of T1 and T2
    as their steps make it: ``SyntheticPairs(seed=SEED)`` cached under the
    run's codec, decoded on the card, augmented with the first step's
    draws, converted to LAB; and the L planes of S2's and St(b)'s
    oversize frames, the inputs their native fallback gives the kernels."""
    from waternet_tpu_torch.data import codec
    from waternet_tpu_torch.data.augment import augment_pair_batch
    from waternet_tpu_torch.data.synthetic import SyntheticPairs
    from waternet_tpu_torch.ops.color import rgb_to_lab_u8
    from waternet_tpu_torch.training.trainer import step_generator
    from waternet_tpu_torch.utils.synthetic import photo_frames

    planes = {}
    for tag, shape in KERNEL_SHAPES.items():
        rgb = torch.from_numpy(photo_frames(rng, *shape)).to(dev)
        planes[tag] = rgb_to_lab_u8(rgb)[..., 0].to(torch.uint8)
    for tag, (n, hw, codec_name) in TRAIN_PLANES.items():
        pairs = SyntheticPairs(n, hw, hw, seed=SEED)
        raw = np.stack([pairs.load_pair(i)[0] for i in range(n)])
        # jaxlint: disable-next=R003 smoke check: reads the result back to compare or time it
        payload = {k: torch.from_numpy(v).to(dev) for k, v in codec.encode(codec_name, raw).items()}
        rgb = codec.decode(codec_name, payload, hw, hw)
        rgb, _ = augment_pair_batch(step_generator(SEED, 0, 0), rgb, rgb)
        planes[tag] = rgb_to_lab_u8(rgb)[..., 0].to(torch.uint8)
    for tag, seed in (("oversize_S2", OVERSIZE_SEEDS["S2"]), ("oversize_St", OVERSIZE_SEEDS["St"])):
        rgb = torch.from_numpy(oversize_frame(seed)[None]).to(dev)
        planes[tag] = rgb_to_lab_u8(rgb)[..., 0].to(torch.uint8)
    return planes


def new_kernels_phase(torch, dev, flush, card, planes) -> dict:
    """Phase 6: dct8_dequant_idct and tile_histogram against their plain
    versions; returns the main-shape row of each."""
    from waternet_tpu_torch.data import codec
    from waternet_tpu_torch.data.synthetic import SyntheticPairs
    from waternet_tpu_torch.ops import kernels
    from waternet_tpu_torch.ops.clahe import clahe_inputs

    summary = {}
    quant = torch.from_numpy(codec.DCT8_QUANT).to(dev)
    idct_m = torch.from_numpy(codec.DCT8_IDCT_MATRIX).to(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for tag, (n, h, w) in DCT8_SHAPES.items():
        pairs = SyntheticPairs(n, h, w, seed=SEED)
        imgs = np.stack([pairs.load_pair(i)[i % 2] for i in range(n)])
        # jaxlint: disable-next=R003 smoke check: reads the result back to compare or time it
        coef5 = torch.from_numpy(codec.encode("dct8", imgs)["coef"]).to(dev).contiguous()
        coef = coef5.reshape(-1, 16)
        nb = coef.shape[0]
        got = kernels.dct8_dequant_idct(coef, quant, idct_m)
        want = kernels.dct8_dequant_idct_plain(coef, quant, idct_m)
        # jaxlint: disable-next=R003 smoke check: reads the result back to compare or time it
        torch.cuda.synchronize()
        # jaxlint: disable-next=R003 smoke check: reads the result back to compare or time it
        check(torch.equal(got, want), f"dct8_dequant_idct != plain at NB={nb}")
        nbytes = nb * 16 + 16 * 4 + 16 * 64 * 4 + nb * 64 * 4
        b_ms, b_by = bound(nbytes, nb * (16 + 2 * 16 * 64))
        r = {
            "ms": device_ms(torch, lambda: kernels.dct8_dequant_idct(coef, quant, idct_m), flush),
            "plain_ms": device_ms(
                torch, lambda: kernels.dct8_dequant_idct_plain(coef, quant, idct_m), flush
            ),
            # Yardstick: dequantize, then one cuBLAS product (TF32 off).
            "library_ms": device_ms(torch, lambda: torch.mm(coef.float() * quant, idct_m), flush),
            "bytes": nbytes, "bound_ms": b_ms, "bound_by": b_by,
            # jaxlint: disable-next=R003 smoke check: reads the result back to compare or time it
            "max_abs_err": (got - want).abs().max().item(),
        }
        # jaxlint: disable-next=R003 smoke check: reads the result back to compare or time it
        lib_err = (torch.mm(coef.float() * quant, idct_m) - want).abs().max().item()
        plan = {"ctas": kernels.dct8_ctas(-(-nb // 16), sms), "store_bytes": 16}
        kernel_line("dct8_dequant_idct", tag, {"nb": nb, "images": [n, h, w]}, r, card,
                    library_max_abs_diff=lib_err, plan=plan)

        # The whole decode, fused, against its plain version and against the
        # path it replaced: the f32 kernel, then the epilogue in eager torch.
        shape4 = tuple(coef5.shape[:4])

        def parent_path():
            return kernels.dct8_blocks_to_u8(kernels.dct8_dequant_idct(coef, quant, idct_m),
                                             shape4, h, w)

        def library_path():
            return kernels.dct8_blocks_to_u8(torch.mm(coef.float() * quant, idct_m), shape4, h, w)

        got = kernels.dct8_decode_u8(coef5, quant, idct_m, h, w)
        want = kernels.dct8_decode_u8_plain(coef5, quant, idct_m, h, w)
        parent = parent_path()
        # jaxlint: disable-next=R003 smoke check: reads the result back to compare or time it
        torch.cuda.synchronize()
        check(got.shape == (n, h, w, 3) and got.dtype == torch.uint8, f"dct8_decode_u8 {got.shape}")
        # jaxlint: disable-next=R003 smoke check: reads the result back to compare or time it
        check(torch.equal(got, want), f"dct8_decode_u8 != plain at {tag} NB={nb}")
        # jaxlint: disable-next=R003 smoke check: reads the result back to compare or time it
        check(torch.equal(got, parent), f"dct8_decode_u8 != the f32 kernel + epilogue at {tag}")
        out_px = n * h * w * 3
        nbytes = nb * 16 + 16 * 4 + 16 * 64 * 4 + out_px
        b_ms, b_by = bound(nbytes, nb * (16 + 2 * 16 * 64) + 4 * out_px)
        r = {
            "ms": device_ms(torch, lambda: kernels.dct8_decode_u8(coef5, quant, idct_m, h, w), flush),
            "plain_ms": device_ms(
                torch, lambda: kernels.dct8_decode_u8_plain(coef5, quant, idct_m, h, w), flush
            ),
            "parent_path_ms": device_ms(torch, parent_path, flush),
            # Yardstick: dequantize, one cuBLAS product, the same epilogue.
            "library_ms": device_ms(torch, library_path, flush),
            "bytes": nbytes, "bound_ms": b_ms, "bound_by": b_by,
            # jaxlint: disable-next=R003 smoke check: reads the result back to compare or time it
            "max_abs_err": (got.int() - want.int()).abs().max().item(),
        }
        lib_err = (library_path().int() - want.int()).abs().max().item()
        nby, nbx = shape4[1:3]
        plan = kernels.dct8_decode_plan(n, nby, nbx, 3, w, got.data_ptr(), sms)._asdict()
        kernel_line("dct8_decode_u8", tag, {"nb": nb, "images": [n, h, w]}, r, card,
                    parent_path_ms=r["parent_path_ms"], equals_parent_path=True,
                    library_max_abs_diff=lib_err, plan=plan)
        if tag == "main":
            # The main path's launch of dct8_dequant_idct is the fused decode.
            summary["dct8_dequant_idct"] = r

    ty, tx = 8, 8
    for tag, lum in planes.items():
        n, h, w = lum.shape
        l_pad, clip, scale, _ = clahe_inputs(lum, tile_grid=(ty, tx))
        hp, wp = l_pad.shape[1:]
        got = kernels.tile_histogram(l_pad, (ty, tx))
        want = kernels.tile_histogram_plain(l_pad, (ty, tx))
        luts = kernels.luts_from_hist(got.reshape(-1, 256), clip, scale).reshape(n, ty, tx, 256)
        # jaxlint: disable-next=R003 smoke check: reads the result back to compare or time it
        torch.cuda.synchronize()
        # jaxlint: disable-next=R003 smoke check: reads the result back to compare or time it
        check(torch.equal(got, want), f"tile_histogram != plain at {tag} {n}x{h}x{w}")
        # jaxlint: disable-next=R003 smoke check: reads the result back to compare or time it
        check(torch.equal(luts, kernels.tile_lut(l_pad, (ty, tx), clip, scale)),
              f"luts_from_hist(tile_histogram) != tile_lut at {tag}")
        nbytes = n * hp * wp + n * ty * tx * 256 * 4
        b_ms, b_by = bound(nbytes)
        keys = tile_keys(torch, l_pad, ty, tx)
        n_bins = n * ty * tx * 256
        # jaxlint: disable-next=R003 smoke check: reads the result back to compare or time it
        check(torch.equal(torch.bincount(keys, minlength=n_bins).reshape(got.shape).to(got.dtype), got),
              f"bincount yardstick != tile_histogram at {tag}")
        r = {
            "ms": device_ms(torch, lambda: kernels.tile_histogram(l_pad, (ty, tx)), flush),
            "plain_ms": device_ms(torch, lambda: kernels.tile_histogram_plain(l_pad, (ty, tx)), flush),
            "library_ms": device_ms(torch, lambda: torch.bincount(keys, minlength=n_bins), flush),
            "bytes": nbytes, "bound_ms": b_ms, "bound_by": b_by,
            # jaxlint: disable-next=R003 smoke check: reads the result back to compare or time it
            "max_abs_err": (got - want).abs().max().item(),
        }
        plan = kernels.tile_plan(n, hp, wp, ty, tx, l_pad.data_ptr(), sms)._asdict()
        kernel_line("tile_histogram", tag, {"n": n, "h": h, "w": w, "padded": [hp, wp]}, r, card,
                    luts_equal_tile_lut=True, plan=plan)
        if tag == "main":
            summary["tile_histogram"] = r
    return summary


def records(stdout: str, tag: str) -> list:
    """Every ``<tag> {...}`` JSON record in a run's stdout, in order.

    A record is found anywhere in a line, not only at its start: processes
    that share one pipe (the supervisor's ranks) write unbuffered under
    ``PYTHONUNBUFFERED``, where ``print`` sends its text and its newline in
    two writes, so one rank's record can land after another's unterminated
    line. Each record is one write below ``PIPE_BUF``, so it stays whole."""
    out, key, dec = [], tag + " {", json.JSONDecoder()
    for ln in stdout.splitlines():
        at = ln.find(key)
        while at >= 0:
            rec, end = dec.raw_decode(ln, at + len(tag) + 1)
            out.append(rec)
            at = ln.find(key, end)
    return out


def train_cli(tag: str, args: list, keep=None):
    """``python -m waternet_tpu_torch.train`` on the card in a fresh run
    root; -> (its epoch_stats lines, its config.json, stdout). ``keep``: a
    directory the run's ``last.npz`` and metric CSVs are copied into."""
    with tempfile.TemporaryDirectory() as root:
        cmd = [sys.executable, "-m", "waternet_tpu_torch.train", "--device", "cuda",
               "--seed", str(SEED), "--train-root", root, *args]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"{tag} CLI failed:\n{proc.stdout}\n{proc.stderr}")
        run = Path(root) / "0"
        for name in ("last.npz", "metrics-train.csv", "metrics-val.csv", "summary.json", "config.json"):
            check((run / name).is_file(), f"{tag}: {name} missing")
        config = json.loads((run / "config.json").read_text())
        if keep is not None:
            for name in ("last.npz", "metrics-train.csv", "metrics-val.csv"):
                shutil.copy(run / name, Path(keep) / name)
    stats = records(proc.stdout, "epoch_stats")
    for s in stats:
        for k, v in list(s["train"].items()) + list(s["val"].items()):
            check(math.isfinite(v), f"{tag} epoch {s['epoch']}: {k} = {v}")
    print(json.dumps({"run": tag, "cli_wall_s": wall}), flush=True)
    return stats, config, proc.stdout


def check_launches(tag: str, s: dict, want: dict, totals: dict):
    """``want``: part ("train", "val") -> (launches per step, steps[,
    launches outside the steps]). An epoch's launches must be the product
    plus those outside the steps (a precache table built in the epoch,
    one launch a chunk); adds them to ``totals``."""
    for part, (per_step, n, *outside) in want.items():
        w = {k: v * n + (outside[0].get(k, 0) if outside else 0) for k, v in per_step.items()}
        check(s["launches"][part] == w, f"{tag} epoch {s['epoch']}: {part} launches {s['launches'][part]}, want {w}")
        for k, v in s["launches"][part].items():
            totals[k] = totals.get(k, 0) + v


def t1_args(precision: str) -> list:
    t = T1
    return ["--synthetic", str(t["synthetic"]), "--val-size", str(t["val_size"]),
            "--epochs", str(t["epochs"]), "--batch-size", str(t["batch"]),
            "--height", str(t["hw"]), "--width", str(t["hw"]), "--precision", precision,
            "--device-cache", "--cache-codec", "dct8"]


def t1_launches(tag: str, s: dict, totals: dict) -> None:
    """One T1 epoch's launches: one dct8 decode and one of each CLAHE
    kernel a train step; the val cache is raw with identity-variant
    precache tables, built in the first val pass (one chunk), so its steps
    launch nothing."""
    t = T1
    val_steps = -(-t["val_size"] // t["batch"])
    check_launches(tag, s, {"train": (dict(CLAHE_ONLY, dct8_dequant_idct=1), s["steps"]),
                            "val": (NO_LAUNCH, val_steps, table_chunks(t["val_size"], t["batch"])
                                    if s["epoch"] == 1 else {})}, totals)


def run_cli_training(torch, card, precision: str, keep=None) -> dict:
    """T1 through ``python -m waternet_tpu_torch.train``; returns the
    launches of all epochs, checked per epoch. ``keep``: where the run's
    weights and CSVs are copied (phase 15 holds its DDP run to them)."""
    t = T1
    stats, config, stdout = train_cli(f"T1 {precision}", t1_args(precision), keep=keep)
    check(config["cache_codec"] == "dct8", f"T1 {precision}: config {config}")
    banner = [ln for ln in stdout.splitlines() if ln.startswith("Device cache:")]
    check(banner, "T1: no Device cache banner")
    check(len(stats) == t["epochs"], f"T1 {precision}: {len(stats)} epoch lines")
    totals = {}
    for s in stats:
        t1_launches(f"T1 {precision}", s, totals)
        flops = step_flops(t["batch"], t["hw"], t["hw"])
        print(json.dumps({
            "run": f"T1 {precision}", "epoch": s["epoch"],
            "train_images_per_s": s["train_images_per_s"], "step_ms": s["step_ms"],
            "step_tflop_estimate": flops / 1e12,
            "tflop_per_s_estimate": flops / (s["step_ms"] * 1e-3) / 1e12,
            "peak_mem_bytes": s["peak_mem_bytes"], "train": s["train"], "val": s["val"],
            "launches": s["launches"], "banner": banner[0], "card": card,
        }), flush=True)
    return totals


def run_t2(torch, dev, card) -> dict:
    """T2: the default config (raw cache, transforms in the step) through
    TrainingEngine; returns the launches of the run, checked per epoch."""
    from waternet_tpu_torch.data.synthetic import SyntheticPairs, synthetic_split
    from waternet_tpu_torch.ops import kernels
    from waternet_tpu_torch.training.trainer import TrainConfig, TrainingEngine

    t = T2
    cfg = TrainConfig(batch_size=t["batch"], im_height=t["hw"], im_width=t["hw"],
                      precision="fp32", cache_codec="raw", precache_histeq=False, seed=SEED)
    ds = SyntheticPairs(t["synthetic"], t["hw"], t["hw"], seed=SEED)
    train_idx, val_idx = synthetic_split(len(ds), t["val_size"])
    engine = TrainingEngine(cfg, device=dev)
    engine.cache_dataset(ds, train_idx)
    steps = -(-len(train_idx) // t["batch"])
    totals = {}
    flops = step_flops(t["batch"], t["hw"], t["hw"])
    for epoch in range(t["epochs"]):
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train = engine.train_epoch_cached(epoch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        val = engine.eval_epoch_cached(ds, val_idx)
        launches = dict(kernels.LAUNCHES)
        for k, v in list(train.items()) + list(val.items()):
            check(math.isfinite(v), f"T2 epoch {epoch + 1}: {k} = {v}")
        want = {"dct8_dequant_idct": 0, "tile_lut": steps + 1, "clahe_lut_planes": steps + 1,
                "tile_histogram": 0}
        check(launches == want, f"T2 epoch {epoch + 1}: launches {launches}, want {want}")
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        print(json.dumps({
            "run": "T2 fp32", "epoch": epoch + 1, "train_images_per_s": len(train_idx) / dt,
            "step_ms": dt / steps * 1e3, "step_tflop_estimate": flops / 1e12,
            "tflop_per_s_estimate": flops / (dt / steps) / 1e12,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(), "train": train, "val": val,
            "launches": launches, "resident_bytes": engine.cache_resident_bytes(), "card": card,
        }), flush=True)
    return totals


def run_t3(torch, dev, card) -> None:
    """T3: one dct8 train step on the card and on the CPU port, from the
    same parameters and batch. The decoded batch must be identical (both
    sides round every op as the plain dct8 version does); the loss and
    metrics agree within rel 1e-4, and each tensor's gradient within 1e-3
    of its largest entry (float32 convolutions summed in other orders:
    cuDNN's algorithms against the CPU's; where the CPU's gradient is 0
    the card's may hold rounding noise, bounded by 1e-6 of the largest
    gradient of all).

    Adam's first step moves each parameter by lr * g / (|g| + eps), about
    lr * sign(g), so every update is within 2 * lr of the other side's.
    Where |g| is at least 100 times its tensor's gradient difference and
    far above eps (|g| >= 1e-6), the sign is certain and the updates agree
    within lr / 1000. Elsewhere (gradients near 0, e.g. of dead ReLU
    channels, where the card's noise meets the CPU's exact 0) only the
    2 * lr bound holds; their share is printed."""
    from waternet_tpu_torch.data.synthetic import SyntheticPairs
    from waternet_tpu_torch.training.trainer import TrainConfig, TrainingEngine, step_generator

    t = T3
    ds = SyntheticPairs(t["batch"], t["hw"], t["hw"], seed=SEED)
    out = {}
    for side in ("cuda", "cpu"):
        cfg = TrainConfig(batch_size=t["batch"], im_height=t["hw"], im_width=t["hw"],
                          precision="fp32", cache_codec="dct8", augment=False, seed=SEED)
        engine = TrainingEngine(cfg, device=side)
        engine.cache_dataset(ds, np.arange(t["batch"]))
        before = {k: v.detach().cpu().clone() for k, v in engine.model.state_dict().items()}
        idx = torch.arange(t["batch"], device=engine.device)
        raw, ref = engine._gather_decode(engine._cache_enc, "dct8", idx)
        step_fn, args = engine.cached_train_step()
        m = step_fn(*args, idx, step_generator(SEED, 0, 0), t["batch"])
        out[side] = {
            "decoded": (raw.cpu(), ref.cpu()),
            "metrics": {k: v.item() for k, v in m.items()},
            "grad": {k: p.grad.detach().cpu() for k, p in engine.model.named_parameters()},
            "delta": {k: v.detach().cpu() - before[k] for k, v in engine.model.state_dict().items()},
            "before": before,
        }
    g, c = out["cuda"], out["cpu"]
    check(all(torch.equal(g["before"][k], c["before"][k]) for k in g["before"]), "T3: params differ")
    check(all(torch.equal(a, b) for a, b in zip(g["decoded"], c["decoded"])), "T3: decoded batch differs")
    rel = {k: abs(g["metrics"][k] - c["metrics"][k]) / max(abs(c["metrics"][k]), 1e-12)
           for k in c["metrics"]}
    check(all(v <= 1e-4 for v in rel.values()), f"T3: metrics rel diff {rel}")

    lr = TrainConfig().lr
    g_all = max(v.abs().max().item() for v in c["grad"].values())
    worst_grad, upd_max, covered, upd_covered_max = 0.0, 0.0, 0, 0.0
    for k, gc in c["grad"].items():
        err = (g["grad"][k] - gc).abs().max().item()
        scale = gc.abs().max().item()
        check(err <= 1e-3 * scale + 1e-6 * g_all,
              f"T3: gradient of {k} differs by {err} (its scale {scale})")
        worst_grad = max(worst_grad, err / max(scale, 1e-30))
        d = (g["delta"][k] - c["delta"][k]).abs()
        upd_max = max(upd_max, d.max().item())
        sure = (gc.abs() >= 100 * err) & (gc.abs() >= 1e-6)
        covered += int(sure.sum())
        if sure.any():
            upd_covered_max = max(upd_covered_max, d[sure].max().item())
    n_params = sum(v.numel() for v in c["grad"].values())
    print(json.dumps({
        "run": "T3 card vs CPU port", "metrics_cuda": g["metrics"], "metrics_cpu": c["metrics"],
        "metrics_rel_diff": rel, "decoded_identical": True,
        "grad_max_diff_over_tensor_scale": worst_grad,
        "update_max_abs_diff": upd_max, "update_max_abs_diff_sign_certain": upd_covered_max,
        "share_sign_certain": covered / n_params, "params": n_params, "card": card,
    }), flush=True)
    check(upd_max <= 2 * lr * (1 + 1e-3), f"T3: an update differs by {upd_max} > 2 lr")
    check(upd_covered_max <= lr / 1000,
          f"T3: a sign-certain update differs by {upd_covered_max} > lr/1000")


def t4_args(epochs: int, workers: int, *extra) -> list:
    t = T4
    return ["--synthetic", str(t["synthetic"]), "--val-size", str(t["val_size"]),
            "--epochs", str(epochs), "--batch-size", str(t["batch"]), "--height", str(t["hw"]),
            "--width", str(t["hw"]), "--precision", t["precision"], "--workers", str(workers), *extra]


def t4_line(tag: str, s: dict, card: str, **extra) -> None:
    """One epoch of a T4 run: throughput, the pipeline's stalls, per-stage
    ms and transfer bytes (train and val), peak memory and launches."""
    pipe = {k: s[k] for k in s if k.startswith("pipeline_")}
    print(json.dumps({
        "run": tag, "epoch": s["epoch"], "train_images_per_s": s["train_images_per_s"],
        "step_ms": s["step_ms"], "train_s": s["train_s"], "val_s": s["val_s"],
        "pipeline": pipe, "val_pipeline": s["val_pipeline"],
        "peak_mem_bytes": s["peak_mem_bytes"], "launches": s["launches"],
        "train": s["train"], "val": s["val"], "card": card, **extra,
    }), flush=True)


def write_uieb_tree(root: Path, n: int, h: int, w: int) -> None:
    """``SyntheticPairs(seed=SEED)`` written with cv2 as a UIEB-layout tree
    (``raw-890/``, ``reference-890/``) of n PNG pairs at h x w."""
    import cv2

    from waternet_tpu_torch.data.synthetic import SyntheticPairs

    pairs = SyntheticPairs(n, h, w, seed=SEED)
    for sub in ("raw-890", "reference-890"):
        (root / sub).mkdir(parents=True)
    for i in range(n):
        for sub, img in zip(("raw-890", "reference-890"), pairs.load_pair(i)):
            check(cv2.imwrite(str(root / sub / f"{i:04d}.png"), cv2.cvtColor(img, cv2.COLOR_RGB2BGR)),
                  f"cv2 could not write {sub}/{i:04d}.png")


def run_score(tag: str, args: list) -> dict:
    with tempfile.TemporaryDirectory() as d:
        out = Path(d) / "metrics.json"
        cmd = [sys.executable, "-m", "waternet_tpu_torch.score", "--device", "cuda",
               "--weights", WEIGHTS, "--json-out", str(out), *args]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"{tag} failed:\n{proc.stdout}\n{proc.stderr}")
        metrics = json.loads(out.read_text())
    check(all(math.isfinite(v) for v in metrics.values()), f"{tag}: {metrics}")
    print(json.dumps({"run": tag, "metrics": metrics, "cli_wall_s": wall}), flush=True)
    return metrics


def run_t4(torch, dev, card) -> dict:
    """T4: host-fed training through the CLI and its cached yardstick, one
    after the other; then, side by side (none of their times is compared),
    a device-preprocess epoch on a cv2-written UIEB tree, a synthetic
    host-preprocess epoch, the scorer in both modes on the tree and the
    engine's bit-for-bit check (:func:`run_t4_exact`). Returns the
    launches of the host-fed runs, checked per epoch."""
    from concurrent.futures import ThreadPoolExecutor

    t = T4
    steps = (t["synthetic"] - t["val_size"]) // t["batch"]
    val_steps = t["val_size"] // t["batch"]
    device_pre = {"train": (CLAHE_ONLY, steps), "val": (CLAHE_ONLY, val_steps)}
    u8_bytes = 2 * t["batch"] * t["hw"] * t["hw"] * 3
    totals, warm = {}, {}
    tag = "T4 workers=2"
    stats, config, _ = train_cli(tag, t4_args(t["epochs"], 2))
    check(len(stats) == t["epochs"] and config["device_preprocess"], f"{tag}: {config}")
    for s in stats:
        check(s["steps"] == steps, f"{tag}: {s['steps']} steps")
        check_launches(tag, s, device_pre, totals)
        for part, p in (("train", s), ("val", s["val_pipeline"])):
            check(p["pipeline_transfer_bytes_per_batch"] == u8_bytes,
                  f"{tag} {part}: {p['pipeline_transfer_bytes_per_batch']} bytes a batch, want {u8_bytes}")
        t4_line(tag, s, card)
    warm[tag] = stats[-1]

    # The same-call yardstick: the cached raw path, WB/GC/CLAHE in the step.
    tag = "T4 cached raw"
    stats = t4_cached_in_process(torch, dev)
    cached_totals = {}
    for s in stats:
        check_launches(tag, s, device_pre, cached_totals)
        t4_line(tag, s, card)
    warm[tag] = stats[-1]
    base = warm[tag]["train_images_per_s"]
    print(json.dumps({
        "run": "T4 warm epoch, host-fed against cached raw",
        "train_images_per_s": {k: v["train_images_per_s"] for k, v in warm.items()},
        "step_ms": {k: v["step_ms"] for k, v in warm.items()},
        "ratio_to_cached": {k: v["train_images_per_s"] / base for k, v in warm.items()},
        "card": card,
    }), flush=True)

    # Side by side: UIEB from --data-root on device preprocessing (cv2
    # writes the tree at 128x160, load_pair resizes to 112x112), a
    # synthetic host-preprocess epoch at the same size (cv2 runs CLAHE on
    # the host, so no kernel launches, and five float32 views a batch),
    # and the scorer in both modes on the tree.
    u, h = T4_UIEB, T4_HOST
    one_epoch = ["--epochs", "1", "--batch-size", str(t["batch"]), "--height", str(t["hw"]),
                 "--width", str(t["hw"]), "--precision", t["precision"], "--workers", "2"]
    views_bytes = 5 * 4 * t["batch"] * t["hw"] * t["hw"] * 3
    with tempfile.TemporaryDirectory() as d, ThreadPoolExecutor(4) as pool:
        tree = Path(d)
        write_uieb_tree(tree, u["pairs"], u["h"], u["w"])
        uieb = pool.submit(train_cli, "T4 UIEB --data-root",
                           ["--data-root", str(tree), "--val-size", str(u["val_size"]), *one_epoch])
        host = pool.submit(train_cli, "T4 host-preprocess", ["--synthetic", str(h["synthetic"]), "--val-size",
                                                             str(h["val_size"]), *one_epoch, "--host-preprocess"])
        paired = pool.submit(run_score, "T4 score, paired", [
            "--data-root", str(tree), "--val-size", str(u["val_size"]),
            "--height", str(t["hw"]), "--width", str(t["hw"]), "--batch-size", str(t["batch"]),
        ])
        nr = pool.submit(run_score, "T4 score, no reference", ["--raw-dir", str(tree / "raw-890"),
                                                               "--batch-size", str(t["batch"])])
        # The engine's bit-for-bit check meanwhile: its bits do not depend
        # on what else runs.
        run_t4_exact(torch, dev, card)
        runs = {"T4 UIEB --data-root": (uieb.result(), u["pairs"], u["val_size"], CLAHE_ONLY, u8_bytes, True),
                "T4 host-preprocess": (host.result(), h["synthetic"], h["val_size"], NO_LAUNCH, views_bytes,
                                       False)}
        paired, nr = paired.result(), nr.result()
    for tag, ((stats, config, _), pairs, val_size, per_step, nbytes, device_preprocess) in runs.items():
        check(len(stats) == 1 and config["device_preprocess"] == device_preprocess, f"{tag}: {config}")
        n_train = pairs - val_size
        for s in stats:
            check(s["train_images"] == n_train, f"{tag}: {s['train_images']} train images")
            check_launches(tag, s, {"train": (per_step, n_train // t["batch"]),
                                    "val": (per_step, val_size // t["batch"])}, totals)
            for part, p in (("train", s), ("val", s["val_pipeline"])):
                check(p["pipeline_transfer_bytes_per_batch"] == nbytes,
                      f"{tag} {part}: {p['pipeline_transfer_bytes_per_batch']} bytes a batch, want {nbytes}")
            t4_line(tag, s, card)
    check(list(paired) == ["mse", "ssim", "psnr", "perceptual_loss"], f"paired keys {list(paired)}")
    check(nr["images"] == u["pairs"], f"no-reference scored {nr['images']} images")
    return totals


def t4_cached_in_process(torch, dev) -> list:
    """T4's same-call yardstick in this process: the cached raw path
    (WB/GC/CLAHE in the step, no precache tables) at T4's config through
    ``TrainingEngine``, as ``python -m waternet_tpu_torch.train
    --device-cache --no-precache-histeq`` runs it, without a process's
    start-up. -> one dict an epoch, with the keys of the CLI's
    ``epoch_stats`` that :func:`t4_line` and :func:`check_launches` read."""
    from waternet_tpu_torch.data.synthetic import SyntheticPairs, synthetic_split
    from waternet_tpu_torch.models.vgg import resolve_vgg_params
    from waternet_tpu_torch.ops import kernels
    from waternet_tpu_torch.training.trainer import TrainConfig, TrainingEngine

    t = T4
    cfg = TrainConfig(batch_size=t["batch"], im_height=t["hw"], im_width=t["hw"], precision=t["precision"],
                      cache_codec="raw", precache_histeq=False, seed=SEED)
    ds = SyntheticPairs(t["synthetic"], t["hw"], t["hw"], seed=SEED)
    train_idx, val_idx = synthetic_split(len(ds), t["val_size"])
    engine = TrainingEngine(cfg, vgg_params=resolve_vgg_params(verbose=False), device=dev)
    engine.cache_dataset(ds, train_idx)
    steps = len(train_idx) // t["batch"]
    stats = []
    for epoch in range(t["epochs"]):
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train = engine.train_epoch_cached(epoch)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_launches = dict(kernels.LAUNCHES)
        kernels.reset_launches()
        val = engine.eval_epoch_cached(ds, val_idx)
        torch.cuda.synchronize()
        stats.append({
            "epoch": epoch + 1, "steps": steps, "train_s": train_s, "val_s": time.perf_counter() - t0 - train_s,
            "train_images_per_s": len(train_idx) / train_s, "step_ms": train_s / steps * 1e3,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(dev), "train": train, "val": val,
            "val_pipeline": {}, "launches": {"train": train_launches, "val": dict(kernels.LAUNCHES)},
        })
    del engine
    torch.cuda.empty_cache()
    return stats


def run_t4_exact(torch, dev, card) -> None:
    """T4's bit-for-bit check on ``TrainingEngine``: 4 fp32 steps of
    16 x 112x112 fed from the host with 2 and 0 workers against the cached
    raw path, with cuDNN's deterministic algorithms for this check only.
    Each step's five input views (recomputed from the step's own batch
    and generator state) and its metrics must be equal."""
    from waternet_tpu_torch.data.synthetic import SyntheticPairs
    from waternet_tpu_torch.ops.fused import fused_train_preprocess
    from waternet_tpu_torch.training.trainer import TrainConfig, TrainingEngine

    t = T4_EXACT
    pairs = SyntheticPairs(t["pairs"], t["hw"], t["hw"], seed=SEED)
    idx = np.arange(t["pairs"])
    runs = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for how in ("cached raw", "workers=2", "workers=0"):
            cfg = TrainConfig(batch_size=t["batch"], im_height=t["hw"], im_width=t["hw"],
                              precision="fp32", cache_codec="raw", precache_histeq=False, seed=SEED)
            engine = TrainingEngine(cfg, device=dev)
            views, metrics = [], []
            step = engine.train_step

            def captured(raw_u8, ref_u8, generator, n_real, *args, step=step, views=views, metrics=metrics):
                g = torch.Generator().set_state(generator.get_state())
                with torch.no_grad():
                    views.append([v.clone() for v in fused_train_preprocess(raw_u8, ref_u8, g, augment=cfg.augment)])
                metrics.append(step(raw_u8, ref_u8, generator, n_real, *args))
                return metrics[-1]

            engine.train_step = captured
            if how == "cached raw":
                engine.cache_dataset(pairs, idx)
                engine.train_epoch_cached(0)
            else:
                engine.train_epoch_pipelined(pairs, idx, 0, workers=int(how[-1]))
            torch.cuda.synchronize()
            runs[how] = (views, [{k: v.item() for k, v in m.items()} for m in metrics])
    finally:
        torch.backends.cudnn.deterministic = deterministic
    want_views, want_metrics = runs["cached raw"]
    check(len(want_views) == t["pairs"] // t["batch"], f"T4 exact: {len(want_views)} steps")
    line = {"run": "T4 host-fed vs cached raw, bit for bit", "steps": len(want_views), "card": card}
    for how in ("workers=2", "workers=0"):
        views, metrics = runs[how]
        check(len(views) == len(want_views), f"T4 exact {how}: {len(views)} steps")
        same = [all(torch.equal(a, b) for a, b in zip(va, vb)) for va, vb in zip(views, want_views)]
        rel = max(abs(m[k] - w[k]) / max(abs(w[k]), 1e-30)
                  for m, w in zip(metrics, want_metrics) for k in w)
        line[how] = {"views_equal_per_step": same, "metrics_equal": metrics == want_metrics,
                     "metrics_max_rel_diff": rel}
    print(json.dumps(line), flush=True)
    for how in ("workers=2", "workers=0"):
        check(all(line[how]["views_equal_per_step"]), f"T4 exact {how}: input views differ")
        check(line[how]["metrics_equal"], f"T4 exact {how}: metrics differ by rel {line[how]['metrics_max_rel_diff']}")


def run_t5(card) -> dict:
    """T5a: ``python -m waternet_tpu_torch.train --device-cache`` at T5
    (the raw cache with its precache tables, the CLI's default), then the
    same with ``--precache-vgg-ref``. The table build launches each CLAHE
    kernel once per chunk (4 train chunks of 8 variants x 16 items, 1 val
    chunk in the first val pass); the precached train and val steps launch
    nothing. Returns the launches of both runs, checked."""
    from waternet_tpu_torch.data import codec
    from waternet_tpu_torch.training.trainer import vgg_ref_bytes_per_item

    t = T5
    n_train = t["synthetic"] - t["val_size"]
    steps, val_steps = -(-n_train // t["batch"]), -(-t["val_size"] // t["batch"])
    totals = {}
    for extra in ([], ["--precache-vgg-ref"]):
        tag = "T5 " + " ".join(["--device-cache", *extra])
        stats, config, stdout = train_cli(tag, [
            "--synthetic", str(t["synthetic"]), "--val-size", str(t["val_size"]),
            "--epochs", str(t["epochs"]), "--batch-size", str(t["batch"]), "--height", str(t["hw"]),
            "--width", str(t["hw"]), "--precision", t["precision"], "--device-cache", *extra,
        ])
        (build,) = records(stdout, "cache_build")
        vgg_ref = bool(extra)
        check(build["precache_histeq"] and build["precache_vgg_ref"] == vgg_ref, f"{tag}: {build}")
        want_bytes = codec.estimate_cache_bytes(
            "raw", n_train, t["hw"], t["hw"], precache_histeq=True, precache_vgg_ref=vgg_ref,
            vgg_ref_bytes_per_item=vgg_ref_bytes_per_item(t["hw"], t["hw"], t["precision"]))
        check(build["hbm_cache_bytes"] == want_bytes == config["cache_resident_bytes"],
              f"{tag}: resident {build['hbm_cache_bytes']}, want {want_bytes}")
        want_build = dict(NO_LAUNCH, **table_chunks(n_train, t["batch"]))
        check(build["launches"] == want_build, f"{tag}: table build launches {build['launches']}, want {want_build}")
        for k, v in build["launches"].items():
            totals[k] = totals.get(k, 0) + v
        check(len(stats) == t["epochs"], f"{tag}: {len(stats)} epoch lines")
        for s in stats:
            check(s["steps"] == steps, f"{tag}: {s['steps']} steps")
            check_launches(tag, s, {"train": (NO_LAUNCH, steps),
                                    "val": (NO_LAUNCH, val_steps, table_chunks(t["val_size"], t["batch"])
                                            if s["epoch"] == 1 else {})}, totals)
        warm = stats[-1]
        print(json.dumps({
            "run": tag, "warm_step_ms": warm["step_ms"], "warm_train_images_per_s": warm["train_images_per_s"],
            "cache_build_sec": build["cache_build_sec"], "hbm_cache_bytes": build["hbm_cache_bytes"],
            "peak_mem_bytes": warm["peak_mem_bytes"], "table_build_launches": build["launches"],
            "launches": [s["launches"] for s in stats], "train": warm["train"], "val": warm["val"], "card": card,
        }), flush=True)
    return totals


def run_t5_exact(torch, dev, card) -> None:
    """T5b on ``TrainingEngine``, fp32, cuDNN's deterministic algorithms,
    16 x 112x112, augment on: 4 precached steps against 4 in-step raw-cache
    steps from the same parameters give the same five input views and the
    same step metrics, bit for bit (WB and gamma commute with every flip
    and rot90; CLAHE is read per variant). The card's WB/GC tables equal
    the CPU port's bit for bit, its CLAHE table is within one level (the
    float LAB inverse). ``precache_vgg_ref``'s epoch metrics are within
    rel 1e-4, abs 1e-6 of the in-step ones (its table runs VGG on another
    batch composition)."""
    from waternet_tpu_torch.data.synthetic import SyntheticPairs
    from waternet_tpu_torch.ops import kernels
    from waternet_tpu_torch.training.trainer import TrainConfig, TrainingEngine, transform_tables

    t = T4_EXACT
    pairs = SyntheticPairs(t["pairs"], t["hw"], t["hw"], seed=SEED)
    idx = np.arange(t["pairs"])
    runs = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for how in ("in-step", "precached", "precached vgg-ref"):
            cfg = TrainConfig(batch_size=t["batch"], im_height=t["hw"], im_width=t["hw"], precision="fp32",
                              cache_codec="raw", precache_histeq=how != "in-step",
                              precache_vgg_ref=how == "precached vgg-ref", seed=SEED)
            engine = TrainingEngine(cfg, device=dev)
            views, metrics = [], []
            step = engine.train_step_pre

            def captured(*args, step=step, views=views, metrics=metrics, **kw):
                views.append([v.clone() for v in args[:5]])
                metrics.append(step(*args, **kw))
                return metrics[-1]

            engine.train_step_pre = captured
            engine.cache_dataset(pairs, idx)
            kernels.reset_launches()
            epoch = engine.train_epoch_cached(0)
            torch.cuda.synchronize()
            runs[how] = {"views": views, "metrics": [{k: v.item() for k, v in m.items()} for m in metrics],
                         "epoch": epoch, "launches": dict(kernels.LAUNCHES), "pre": engine._cache_pre,
                         "pair": engine._cache_enc["raw"]}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    want, got = runs["in-step"], runs["precached"]
    n_steps = t["pairs"] // t["batch"]
    check(len(want["views"]) == len(got["views"]) == n_steps, f"T5 exact: {len(got['views'])} steps")
    same = [all(torch.equal(a, b) for a, b in zip(va, vb)) for va, vb in zip(got["views"], want["views"])]
    rel = max(abs(m[k] - w[k]) / max(abs(w[k]), 1e-30) for m, w in zip(got["metrics"], want["metrics"]) for k in w)

    # The tables: the card's against the CPU port's from the same pairs.
    raw_cpu = got["pair"][0].cpu()
    cpu_wb, cpu_gc, cpu_he = transform_tables(raw_cpu, 8, t["batch"])
    pre = got["pre"]
    he_diff = (pre["he"].cpu().int() - cpu_he.int()).abs()
    vgg_diff = {k: abs(runs["precached vgg-ref"]["epoch"][k] - got["epoch"][k]) for k in got["epoch"]}
    line = {
        "run": "T5 precached vs in-step raw cache, bit for bit", "steps": n_steps,
        "views_equal_per_step": same, "metrics_equal": got["metrics"] == want["metrics"],
        "metrics_max_rel_diff": rel, "launches": {k: runs[k]["launches"] for k in runs},
        "wb_table_equal_cpu": torch.equal(pre["wb"].cpu(), cpu_wb),
        "gc_table_equal_cpu": torch.equal(pre["gc"].cpu(), cpu_gc),
        "he_table_vs_cpu": {"max_abs_diff": he_diff.max().item(),
                            "share_differing": (he_diff > 0).float().mean().item()},
        "vgg_ref_epoch": runs["precached vgg-ref"]["epoch"], "in_step_epoch": got["epoch"],
        "vgg_ref_abs_diff": vgg_diff, "card": card,
    }
    print(json.dumps(line), flush=True)
    check(all(same), "T5 exact: input views differ")
    check(line["metrics_equal"], f"T5 exact: metrics differ by rel {rel}")
    check(runs["in-step"]["launches"] == dict(CLAHE_ONLY, tile_lut=n_steps, clahe_lut_planes=n_steps),
          f"T5 exact: in-step launches {runs['in-step']['launches']}")
    for how in ("precached", "precached vgg-ref"):
        check(runs[how]["launches"] == NO_LAUNCH, f"T5 exact {how}: step launches {runs[how]['launches']}")
    check(line["wb_table_equal_cpu"] and line["gc_table_equal_cpu"], "T5: WB/GC tables differ from the CPU port's")
    check(line["he_table_vs_cpu"]["max_abs_diff"] <= 1, f"T5: CLAHE table off by {line['he_table_vs_cpu']}")
    for k, w in got["epoch"].items():
        v = runs["precached vgg-ref"]["epoch"][k]
        check(abs(v - w) <= 1e-6 + 1e-4 * abs(w), f"T5: precache_vgg_ref {k} = {v}, in-step {w}")


BENCH_METRIC = {(): "uieb_train_images_per_sec_per_chip",
                ("--config", "train_fullres"): "train_fullres_devcache_images_per_sec",
                ("--config", "video"): "video_1080p_frames_per_sec_per_chip",
                ("--config", "serve"): "mixed_res_dir_images_per_sec",
                ("--config", "serve_http"): "http_images_per_sec",
                ("--config", "tiers"): "fast_tier_images_per_sec",
                ("--config", "serve_adaptive"): "adaptive_p50_ms",
                ("--config", "serve_chaos"): "chaos_images_per_sec",
                ("--config", "serve_fleet"): "fleet_images_per_sec",
                ("--config", "stream"): "video_stream_fps",
                ("--config", "stream_reuse"): "stream_reuse_fps",
                ("--config", "obs"): "obs_overhead_pct",
                ("--config", "train_chaos"): "chaos_train_images_per_sec",
                ("--config", "serve_multi"): "mixed_res_dir_images_per_sec_multidev"}


def run_bench(card, *args, env=None) -> dict:
    """``python -m waternet_tpu_torch.bench`` as a subprocess (``env``:
    variables added to its environment); it must exit 0 and end in its
    contract line, with a finite positive value and ``mfu`` in (0, 1]
    where the line has one. Echoes every line; returns the last."""
    import os

    cmd = [sys.executable, "-m", "waternet_tpu_torch.bench", "--device", "cuda", *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600,
                          env={**os.environ, **(env or {})})
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"bench {args} failed:\n{proc.stdout}\n{proc.stderr}")
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    for ln in lines:
        print("bench " + json.dumps(dict(ln, card=card)), flush=True)
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    want = BENCH_METRIC[args]
    check(last["metric"] == want, f"bench {args}: last line {last['metric']}")
    check(math.isfinite(last["value"]) and last["value"] > 0, f"bench {args}: value {last['value']}")
    if "mfu" in last:
        check(last["mfu"] is not None and 0 < last["mfu"] <= 1, f"bench {args}: mfu {last['mfu']}")
    print(json.dumps({"run": "bench " + " ".join(args), "cli_wall_s": wall}), flush=True)
    return last


def probe_video_io(d: Path) -> str:
    """V1: open a writer of each fourcc on a 1080p clip, write and read
    back two frames; print what opened and cv2's "Video I/O" build
    section. Returns the fourcc the test clip is written with (mp4v, as
    the tests write theirs, else avc1); fails if neither opens."""
    import cv2

    v = VIDEO
    probe = {}
    frame = np.zeros((v["h"], v["w"], 3), np.uint8)
    for fourcc in ("avc1", "mp4v"):
        path = d / f"probe_{fourcc}.mp4"
        writer = cv2.VideoWriter(str(path), cv2.VideoWriter.fourcc(*fourcc), v["fps"], (v["w"], v["h"]))
        opened = writer.isOpened()
        if opened:
            for _ in range(2):
                writer.write(frame)
        writer.release()
        read = 0
        if opened:
            cap = cv2.VideoCapture(str(path))
            while cap.read()[0]:
                read += 1
            cap.release()
        probe[fourcc] = {"opened": opened, "frames_read": read}
    info = cv2.getBuildInformation()
    section = info[info.find("Video I/O"):]
    section = section[: section.find("\n\n")] if "\n\n" in section else section[:1200]
    print(json.dumps({"cv2_video_probe": probe, "cv2_version": cv2.__version__}), flush=True)
    print("cv2 build, " + section.strip(), flush=True)
    usable = [k for k in ("mp4v", "avc1") if probe[k]["opened"] and probe[k]["frames_read"] == 2]
    check(usable, f"no mp4 encoder of cv2 opens and reads back: {probe}")
    return usable[0]


def write_clip(path: Path, fourcc: str, rng) -> None:
    """V2: VIDEO["frames"] 1080x1920 crops of one seeded ``photo_frames``
    frame, panning by VIDEO["pan"] a frame, into an mp4."""
    import cv2

    from waternet_tpu_torch.utils.synthetic import photo_frames

    v = VIDEO
    (sy, sx), n = v["pan"], v["frames"]
    big = photo_frames(rng, 1, v["h"] + n * sy, v["w"] + n * sx)[0]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter.fourcc(*fourcc), v["fps"], (v["w"], v["h"]))
    check(writer.isOpened(), f"cv2 could not open a {fourcc} writer for the test clip")
    for t in range(n):
        writer.write(np.ascontiguousarray(big[t * sy:t * sy + v["h"], t * sx:t * sx + v["w"]]))
    writer.release()


def read_frames(path: Path) -> list:
    import cv2

    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f)
    cap.release()
    return out


def stream_pass(engine, clip: Path, prefetch: int = 2):
    """One ``enhance_video_stream`` pass; -> (pairs, ingest stats, seconds)."""
    import cv2

    from waternet_tpu_torch.data.video import enhance_video_stream

    cap = cv2.VideoCapture(str(clip))
    check(cap.isOpened(), f"cv2 cannot open {clip}")
    stats = {}
    t0 = time.perf_counter()
    pairs = list(enhance_video_stream(engine, cap, batch_size=VIDEO["batch"], stats=stats, prefetch=prefetch))
    dt = time.perf_counter() - t0
    cap.release()
    return pairs, stats, dt


def run_video(torch, dev, card, r1_fp32: dict) -> dict:
    """Phase 10 (V): the video path on a bf16 engine, R1 in bf16, the CLI
    on the clip, flicker and the bench's video line, from its own seeded
    generator. Returns the launches of the counted stream pass."""
    import cv2

    from waternet_tpu_torch.data.video import _read_batches
    from waternet_tpu_torch.inference_engine import InferenceEngine
    from waternet_tpu_torch.metrics.flicker import flicker_index
    from waternet_tpu_torch.ops import kernels
    from waternet_tpu_torch.utils.synthetic import photo_frames

    v = VIDEO
    rng = np.random.default_rng(SEED + 10)
    n_batches = -(-v["frames"] // v["batch"])
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        fourcc = probe_video_io(d)
        clip = d / "clip.mp4"
        write_clip(clip, fourcc, rng)
        engine = InferenceEngine(weights=WEIGHTS, device_preprocess=True, dtype=torch.bfloat16)

        # The counted pass: the stream as the CLI runs it.
        kernels.reset_launches()
        pairs, stats, dt_first = stream_pass(engine, clip)
        counted = dict(kernels.LAUNCHES)
        check(len(pairs) == v["frames"], f"V: the stream gave {len(pairs)} frames, want {v['frames']}")
        check(stats == {"frames_decoded": v["frames"]}, f"V: ingest {stats}")
        want = dict(NO_LAUNCH, tile_lut=n_batches, clahe_lut_planes=n_batches)
        check(counted == want, f"V: stream launches {counted}, want {want}")

        # The same decoded, padded batches through engine.enhance.
        cap = cv2.VideoCapture(str(clip))
        batches = list(_read_batches(cap, v["batch"], {}))
        cap.release()
        check([len(b) for b, _ in batches] == [v["batch"]] * (n_batches - 1) + [v["frames"] % v["batch"]],
              f"V: batch sizes {[len(b) for b, _ in batches]}")
        i = 0
        for bgr, rgb in batches:
            check(rgb.shape == (v["batch"], v["h"], v["w"], 3), f"V: padded batch {rgb.shape}")
            out = engine.enhance(rgb)
            for k in range(len(bgr)):
                got_in, got_out = pairs[i]
                check(np.array_equal(got_in, bgr[k]), f"V: input frame {i} out of order")
                check(np.array_equal(got_out, cv2.cvtColor(out[k], cv2.COLOR_RGB2BGR)),
                      f"V: frame {i} differs from engine.enhance on its padded batch")
                i += 1
        enhanced = [o for _, o in pairs]
        for o in enhanced:
            check(o.shape == (v["h"], v["w"], 3) and o.dtype == np.uint8 and o.std() > 0, "V: bad frame")
        inputs = [f for f, _ in pairs]
        del pairs, batches

        # Warm passes: with the decode thread, and decoding inline.
        _, _, dt_warm = stream_pass(engine, clip)
        _, _, dt_inline = stream_pass(engine, clip, prefetch=0)
        print(json.dumps({
            "run": "V stream", "frames": v["frames"], "batch": v["batch"], "batches": n_batches,
            "fourcc": fourcc, "launches": counted, "equals_engine_enhance": True,
            "first_pass_s": dt_first, "warm_frames_per_s": v["frames"] / dt_warm,
            "warm_frames_per_s_prefetch_0": v["frames"] / dt_inline, "card": card,
        }), flush=True)

        # bf16 R1, beside phase 5's fp32 R1.
        r1 = photo_frames(rng, *REQUESTS["R1"])
        engine.enhance(r1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lat = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.enhance(r1)
            lat.append(time.perf_counter() - t0)
        p50 = statistics.median(lat)
        # How long enhance_async takes to return: on an idle card, and while
        # the previous R1 batch still runs (the video stream's case).
        idle, busy = [], []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            first = engine.enhance_async(r1)
            idle.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            second = engine.enhance_async(r1)
            busy.append(time.perf_counter() - t0)
            enqueued = torch.cuda.Event()
            enqueued.record()
            still_running = not enqueued.query()
            torch.cuda.synchronize()
            del first, second
        print(json.dumps({
            "request": "R1 bf16 x5", "latency_ms_p50": p50 * 1e3, "latency_ms": [t * 1e3 for t in lat],
            "frames_per_s": REQUESTS["R1"][0] / p50, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "fp32_latency_ms_p50": r1_fp32["latency_ms_p50"], "fp32_peak_mem_bytes": r1_fp32["peak_mem_bytes"],
            "speedup_over_fp32": r1_fp32["latency_ms_p50"] / (p50 * 1e3),
            "enhance_async_return_ms_idle": statistics.median(idle) * 1e3,
            "enhance_async_return_ms_behind_r1": statistics.median(busy) * 1e3,
            "queue_still_busy_after_second_enqueue": still_running, "card": card,
        }), flush=True)

        # A bf16 request on the card against the CPU port's bf16 engine.
        small = photo_frames(rng, *BF16_VS_CPU)
        cpu = InferenceEngine(weights=WEIGHTS, device_preprocess=True, device="cpu", dtype=torch.bfloat16)
        diff = np.abs(engine.enhance(small).astype(np.int16) - cpu.enhance(small).astype(np.int16))
        line = {"bf16_vs_cpu": {"shape": list(small.shape), "max_abs_diff": int(diff.max()),
                                "share_over_one": float((diff > 1).mean()),
                                "share_differing": float((diff > 0).mean())}}
        print(json.dumps(line), flush=True)
        check(diff.max() <= 3 and (diff > 1).mean() <= 0.01, f"V: bf16 card vs CPU port {line}")
        del engine, cpu
        torch.cuda.empty_cache()

        # The CLI on the clip.
        out_root = d / "out"
        cmd = [sys.executable, "-m", "waternet_tpu_torch.inference", "--source", str(clip),
               "--weights", WEIGHTS, "--device-preprocess", "--precision", "bf16",
               "--batch-size", str(v["batch"]), "--show-split", "--workers", "2",
               "--output-root", str(out_root)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"V CLI failed:\n{proc.stdout}\n{proc.stderr}")
        (ingest,) = [json.loads(ln)["video_ingest"] for ln in proc.stdout.splitlines()
                     if ln.startswith('{"video_ingest"')]
        written = read_frames(out_root / "0" / "clip.mp4")
        print(json.dumps({
            "run": "V CLI", "cli_wall_s": wall, "video_ingest": ingest, "frames_read_back": len(written),
            "encoder_fallback": "avc1 encoder unavailable" in proc.stdout, "card": card,
        }), flush=True)
        check(ingest["frames_decoded"] == ingest["frames_written"] == v["frames"]
              and ingest["decode_failures_mid_stream"] == 0, f"V CLI: ingest {ingest}")
        check(len(written) == v["frames"] and all(f.shape == (v["h"], v["w"], 3) for f in written),
              f"V CLI: {len(written)} frames written back")
        del written

    # Flicker of the decoded input and of the enhanced clip, on the card:
    # under the pan's true flow, and under the identity flow.
    def pan_flow(prev, nxt):
        flow = torch.empty((*prev.shape[:2], 2), dtype=torch.float32, device=prev.device)
        flow[..., 0], flow[..., 1] = v["pan"][1], v["pan"][0]
        return flow

    frames = {"input": [torch.from_numpy(f).to(dev) for f in inputs],
              "enhanced": [torch.from_numpy(f).to(dev) for f in enhanced]}
    print(json.dumps({"V flicker_index": {
        k: {"true_flow": flicker_index(f, flow_fn=pan_flow), "identity_flow": flicker_index(f)}
        for k, f in frames.items()}, "card": card}), flush=True)
    del frames
    del inputs, enhanced
    run_bench(card, "--config", "video")
    return counted


def state_tensors(torch, engine) -> dict:
    """Every tensor of an engine's train state (parameters, Adam's moments
    and steps) by path, copied to the host."""
    st = engine.train_state()
    out = {f"model/{k}": v for k, v in st["model"].items()}
    for i, s in st["optimizer"]["state"].items():
        out.update({f"optimizer/{i}/{k}": v for k, v in s.items()})
    return {k: v.detach().to("cpu", copy=True) for k, v in out.items()}


def run_resume_engine(torch, dev, card, tag: str) -> dict:
    """R1 (dct8 cache) or R2 (host-fed, pipelined): the same 2-epoch run
    uninterrupted, and interrupted by a real SIGTERM (``sigterm@K``) then
    resumed in a fresh engine through ``auto_resume``; fp32 with cuDNN's
    deterministic algorithms. The marker's position, the final parameters
    and moments and the epoch-2 metrics are checked bit for bit, and each
    kernel's launches against the steps dispatched. Returns the launches of
    both runs."""
    import threading

    from waternet_tpu_torch.data.synthetic import SyntheticPairs, synthetic_split
    from waternet_tpu_torch.ops import kernels
    from waternet_tpu_torch.resilience import (CheckpointManager, EpochControl, Preempted,
                                               PreemptionGuard, auto_resume, faults)
    from waternet_tpu_torch.training.trainer import TrainConfig, TrainingEngine

    dct8 = tag == "R1"
    t = RESUME_R1 if dct8 else RESUME_R2
    cfg = dict(batch_size=t["batch"], im_height=t["hw"], im_width=t["hw"], precision="fp32", seed=SEED,
               cache_codec="dct8" if dct8 else "raw")
    if dct8:
        ds = SyntheticPairs(t["synthetic"], t["hw"], t["hw"], seed=SEED)
        idx = synthetic_split(len(ds), t["val_size"])[0]
    else:
        ds = SyntheticPairs(t["pairs"], t["hw"], t["hw"], seed=SEED)
        idx = np.arange(t["pairs"])
    steps = -(-len(idx) // t["batch"])
    per_step = dict(CLAHE_ONLY, dct8_dequant_idct=int(dct8))

    def engine():
        eng = TrainingEngine(TrainConfig(**cfg), device=dev)
        if dct8:
            eng.cache_dataset(ds, idx)
        return eng

    def epoch(eng, e, **kw):
        if dct8:
            return eng.train_epoch_cached(e, **kw)
        return eng.train_epoch_pipelined(ds, idx, e, workers=t["workers"], **kw)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as d, PreemptionGuard() as guard:
            root = Path(d)
            # Uninterrupted.
            full = engine()
            kernels.reset_launches()
            for e in range(t["epochs"]):
                m_full = epoch(full, e, control=EpochControl(preemption=guard))
            torch.cuda.synchronize()
            launches_full = dict(kernels.LAUNCHES)
            want_full = {k: v * steps * t["epochs"] for k, v in per_step.items()}
            check(launches_full == want_full, f"{tag} uninterrupted: launches {launches_full}, want {want_full}")
            want_state = state_tensors(torch, full)
            del full

            # Interrupted by a real SIGTERM, checkpointed at the boundary.
            run = root / "0"
            mgr = CheckpointManager(run / "checkpoints")
            eng = engine()
            faults.install(faults.FaultPlan.parse(f"sigterm@{t['sigterm']}"))
            kernels.reset_launches()
            try:
                for e in range(t["epochs"]):
                    epoch(eng, e, control=EpochControl(preemption=guard))
                check(False, f"{tag}: sigterm@{t['sigterm']} did not preempt")
            except Preempted as pre:
                mgr.save(eng, meta={"epoch": e, "batch_index": pre.next_batch, "partial_metrics": pre.partial})
            finally:
                faults.clear()
            torch.cuda.synchronize()
            launches_cut = dict(kernels.LAUNCHES)
            guard.requested = False
            leaked = [th.name for th in threading.enumerate() if th.name.startswith("waternet-pipeline")]
            check(not leaked, f"{tag}: pipeline threads left after the preemption: {leaked}")
            meta = json.loads(next((run / "checkpoints").glob("step-*/_COMPLETE.json")).read_text())
            where = (meta["epoch"], meta["batch_index"])
            check(where == (1, 3) and meta["step"] == t["sigterm"],
                  f"{tag}: checkpoint at (epoch, batch) {where}, step {meta['step']}")
            state_bytes = (next((run / "checkpoints").glob("step-*")) / "state" / "state.pt").stat().st_size
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.checkpoint(root / "probe")
            save_s = time.perf_counter() - t0
            del eng

            # Resumed in a fresh engine.
            res = engine()
            t0 = time.perf_counter()
            got = auto_resume(res, root)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            check(got is not None and got["batch_index"] == 3, f"{tag}: auto_resume gave {got}")
            kernels.reset_launches()
            m_res = epoch(res, got["epoch"], start_batch=got["batch_index"], carry=got["partial_metrics"],
                          control=EpochControl(preemption=guard))
            torch.cuda.synchronize()
            launches_res = dict(kernels.LAUNCHES)
            got_state = state_tensors(torch, res)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    steps_cut = t["sigterm"]
    steps_res = steps * t["epochs"] - steps_cut
    for what, got_l, n in (("interrupted", launches_cut, steps_cut), ("resumed", launches_res, steps_res)):
        want = {k: v * n for k, v in per_step.items()}
        check(got_l == want, f"{tag} {what}: launches {got_l}, want {want}")
    same = [k for k in want_state if torch.equal(want_state[k], got_state[k])]
    keys = TRAIN_KEYS
    line = {
        "run": f"{tag} resume", "feed": "dct8 cache" if dct8 else f"host-fed, {t['workers']} workers",
        "steps_per_epoch": steps, "checkpoint_at": {"epoch": where[0], "batch_index": where[1],
                                                     "step": meta["step"]},
        "tensors_equal": f"{len(same)}/{len(want_state)}",
        "epoch2_metrics_equal": all(m_res[k] == m_full[k] for k in keys),
        "epoch2_metrics": {k: m_res[k] for k in keys},
        "launches": {"uninterrupted": launches_full, "interrupted": launches_cut, "resumed": launches_res},
        "checkpoint_save_s": save_s, "restore_s": restore_s,
        "state_bytes": state_bytes,
        "card": card,
    }
    print(json.dumps(line), flush=True)
    check(len(same) == len(want_state), f"{tag}: {len(want_state) - len(same)} state tensors differ")
    check(line["epoch2_metrics_equal"], f"{tag}: epoch-2 metrics differ: {m_res} vs {m_full}")
    return {k: launches_cut[k] + launches_res[k] for k in launches_cut}


def run_resume_nan(torch, dev, card) -> dict:
    """R3: R1's config, one epoch with ``nan@K`` under the default sentinel
    (window 16, so the epoch's 7 steps are checked at its end): one skip,
    one rollback, finite parameters. The epoch dispatches its 7 steps, then
    replays the 6 good ones from the epoch-start snapshot: 13 launches of
    each kernel."""
    from waternet_tpu_torch.data.synthetic import SyntheticPairs, synthetic_split
    from waternet_tpu_torch.ops import kernels
    from waternet_tpu_torch.resilience import DivergenceSentinel, EpochControl, faults
    from waternet_tpu_torch.training.trainer import TrainConfig, TrainingEngine

    t = RESUME_R1
    ds = SyntheticPairs(t["synthetic"], t["hw"], t["hw"], seed=SEED)
    idx = synthetic_split(len(ds), t["val_size"])[0]
    steps = -(-len(idx) // t["batch"])
    eng = TrainingEngine(TrainConfig(batch_size=t["batch"], im_height=t["hw"], im_width=t["hw"],
                                     precision="fp32", seed=SEED, cache_codec="dct8"), device=dev)
    eng.cache_dataset(ds, idx)
    faults.install(faults.FaultPlan.parse(f"nan@{t['nan']}"))
    kernels.reset_launches()
    try:
        m = eng.train_epoch_cached(0, control=EpochControl(sentinel=DivergenceSentinel()))
    finally:
        faults.clear()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    dispatched = steps + (steps - 1)
    want = {k: v * dispatched for k, v in dict(CLAHE_ONLY, dct8_dequant_idct=1).items()}
    finite = all(bool(torch.isfinite(p).all()) for p in eng.model.parameters())
    print(json.dumps({"run": "R3 NaN sentinel", "nan_at_step": t["nan"], "steps": steps,
                      "nan_skipped": m["nan_skipped"], "nan_rollbacks": m["nan_rollbacks"],
                      "dispatched": dispatched, "launches": launches, "params_finite": finite,
                      "train": {k: m[k] for k in TRAIN_KEYS}, "card": card}), flush=True)
    check(m["nan_skipped"] == 1 and m["nan_rollbacks"] == 1, f"R3: skipped {m['nan_skipped']}, "
          f"rollbacks {m['nan_rollbacks']}")
    check(finite and all(math.isfinite(m[k]) for k in TRAIN_KEYS), f"R3: not finite: {m}")
    check(launches == want, f"R3: launches {launches}, want {want}")
    return launches


def run_resume_cli(torch, card) -> dict:
    """R4: ``python -m waternet_tpu_torch.train`` at T4's bf16 config with
    --heartbeat-dir, --perf-csv and --profile-dir: uninterrupted, then
    interrupted by ``WATERNET_FAULTS=sigterm@K`` and continued with
    ``--resume auto``. Returns the launches of the interrupted and resumed
    runs' completed epochs. The uninterrupted and the interrupted runs go
    side by side (they share the card; no time of theirs is compared)."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    t = T4
    n_steps = (t["synthetic"] - t["val_size"]) // t["batch"] * t["epochs"]
    totals = {}
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)

        def cli(name, root, *extra, faults_spec=None):
            env = dict(os.environ)
            env.pop("WATERNET_FAULTS", None)
            if faults_spec:
                env["WATERNET_FAULTS"] = faults_spec
            cmd = [sys.executable, "-m", "waternet_tpu_torch.train", "--device", "cuda", "--seed", str(SEED),
                   "--train-root", str(root), "--heartbeat-dir", str(d / name / "hb"), "--perf-csv",
                   "--profile-dir", str(d / name / "prof"), *t4_args(t["epochs"], 2), *extra]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
            wall = time.perf_counter() - t0
            check(proc.returncode == 0, f"R4 {name} CLI failed:\n{proc.stdout}\n{proc.stderr}")
            stats = records(proc.stdout, "epoch_stats")
            beat = json.loads((d / name / "hb" / "worker-000.json").read_text())
            return proc.stdout, stats, beat, wall

        with ThreadPoolExecutor(2) as pool:  # the uninterrupted run beside the interrupted one
            full = pool.submit(cli, "full", d / "full")
            cut = pool.submit(cli, "cut", d / "runs", faults_spec=f"sigterm@{RESUME_R4['sigterm']}")
            (out_full, stats_full, beat_full, wall_full), (out_cut, stats_cut, beat_cut, wall_cut) = (
                full.result(), cut.result())
        out_res, stats_res, beat_res, wall_res = cli("resumed", d / "runs", "--resume", "auto")
        step_full = torch.load(d / "full" / "0" / "state" / "state.pt", weights_only=True)["step"]
        step_res = torch.load(d / "runs" / "1" / "state" / "state.pt", weights_only=True)["step"]
        meta = json.loads(max((d / "runs" / "0" / "checkpoints").glob("step-*/_COMPLETE.json")).read_text())
        perf = np.loadtxt(d / "runs" / "1" / "metrics-train.csv", delimiter=",", skiprows=1, ndmin=2)
        header = (d / "runs" / "1" / "metrics-train.csv").read_text().splitlines()[0].split(",")
        perf_full = np.loadtxt(d / "full" / "0" / "metrics-train.csv", delimiter=",", skiprows=1, ndmin=2)
        trace_path = d / "resumed" / "prof" / "trace.json"
        trace_text = trace_path.read_text()
        trace_bytes = trace_path.stat().st_size
    col = {k: header.index(k) for k in ("mfu_live", "hbm_peak_bytes")}
    kernels_in_trace = {k: k in trace_text for k in ("clahe_tile_lut_kernel", "clahe_lut_blend_kernel")}
    for s in stats_cut + stats_res:
        for k, v in s["launches"]["train"].items():
            totals[k] = totals.get(k, 0) + v
        for k, v in s["launches"]["val"].items():
            totals[k] = totals.get(k, 0) + v
    metrics = [v for s in stats_res for v in list(s["train"].values()) + list(s["val"].values())]
    line = {
        "run": "R4 CLI resume, bf16", "uninterrupted_step": step_full, "resumed_step": step_res,
        "want_step": n_steps, "checkpoint_at": {k: meta[k] for k in ("epoch", "batch_index", "step")},
        "preempted_line": [ln for ln in out_cut.splitlines() if ln.startswith("Preempted")],
        "resumed_line": [ln for ln in out_res.splitlines() if ln.startswith("Resuming")],
        "heartbeat_last": {"full": beat_full["phase"], "cut": beat_cut["phase"], "resumed": beat_res["phase"]},
        "perf_csv_last_row": {k: float(perf[-1, i]) for k, i in col.items()},
        "perf_csv_full": {k: perf_full[:, i].tolist() for k, i in col.items()},
        "trace_bytes": trace_bytes, "kernels_in_trace": kernels_in_trace,
        "epochs_printed": {"cut": len(stats_cut), "resumed": len(stats_res)},
        "resumed_epoch": stats_res[0] if stats_res else None,
        "cli_wall_s": {"full": wall_full, "cut": wall_cut, "resumed": wall_res}, "card": card,
    }
    print(json.dumps(line), flush=True)
    check(step_full == n_steps and step_res == step_full, f"R4: steps {step_full} (uninterrupted), "
          f"{step_res} (resumed), want {n_steps}")
    per_epoch = n_steps // t["epochs"]
    want_at = divmod(RESUME_R4["sigterm"], per_epoch)
    check((meta["epoch"], meta["batch_index"]) == want_at, f"R4: checkpoint at {meta}, want {want_at}")
    check(beat_res["phase"] == "done" and beat_full["phase"] == "done" and beat_cut["phase"] == "preempted",
          f"R4: heartbeats {line['heartbeat_last']}")
    check(len(stats_cut) == 1 and len(stats_res) == 1, f"R4: epochs printed {line['epochs_printed']}")
    check(all(math.isfinite(v) for v in metrics), "R4: resumed metrics not finite")
    mfu, hbm = line["perf_csv_last_row"]["mfu_live"], line["perf_csv_last_row"]["hbm_peak_bytes"]
    check(0 < mfu <= 1 and hbm > 0, f"R4: --perf-csv mfu_live {mfu}, hbm_peak_bytes {hbm}")
    check(all(kernels_in_trace.values()), f"R4: kernels in the Chrome trace: {kernels_in_trace}")
    return totals


def _png(rgb) -> bytes:
    import cv2

    ok, buf = cv2.imencode(".png", np.ascontiguousarray(rgb[:, :, ::-1]))
    check(ok, "PNG encode failed")
    return buf.tobytes()


def _unpng(body) -> np.ndarray:
    import cv2

    bgr = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
    check(bgr is not None, "a response is not a decodable PNG")
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def span_breakdown() -> dict:
    """Per span name of the serving trace (``waternet_tpu_torch.obs.
    trace``): how many, and their median and mean ms. The serving spans
    are per request: decode, queue_wait, coalesce, replica_launch (host
    preprocessing and the enqueue of its batch), device (launch start to
    the readback's event), d2h, response_write, serve (submit to result)."""
    from waternet_tpu_torch.obs import trace

    events, _ = trace.recorder().snapshot()
    by_name = {}
    for name, _cat, ph, _t0, dur, _tid, _args in events:
        if ph == "X":
            by_name.setdefault(name, []).append(dur * 1e3)
    return {name: {"n": len(v), "median_ms": statistics.median(v), "mean_ms": statistics.fmean(v)}
            for name, v in sorted(by_name.items())}


def serve_over_http(engine, ladder, images, extra=()):
    """Serve ``images`` (then each of ``extra``, one by one) through an
    in-process ``ServingServer`` on an ephemeral port, driven by
    ``run_load`` with the serving trace armed; each kernel's launches are
    counted from 0 around the requests. -> (answers in image order, load
    report, stats, launches, warmup s, :func:`span_breakdown` of the
    images' requests)."""
    from waternet_tpu_torch.obs import trace
    from waternet_tpu_torch.ops import kernels
    from waternet_tpu_torch.serving.loadgen import run_load
    from waternet_tpu_torch.serving.server import ServingServer

    n = len(images)
    server = ServingServer(engine, ladder, max_batch=SERVE["max_batch"], max_wait_ms=5.0, replicas=1,
                           max_queue=256)
    t0 = time.perf_counter()
    server.start_background(timeout=60)
    try:
        server.wait_ready(timeout=300)
        warmup_s = time.perf_counter() - t0
        kernels.reset_launches()
        trace.reset()
        trace.enable()
        try:
            rep = run_load(server.url, [_png(im) for im in images], concurrency=SERVE["concurrency"],
                           total=n, keep_bodies=True)
        finally:
            trace.disable()
        spans = span_breakdown()
        extra_reps = [run_load(server.url, [_png(im)], concurrency=1, total=1, keep_bodies=True)
                      for im in extra]
        launches = dict(kernels.LAUNCHES)
    finally:
        server.request_drain()
        code = server.join(timeout=300)
    check(code == 0, f"S: the server's drain exited {code}")
    check(rep["ok"] == n and rep["errors"] == 0, f"S: load report {rep}")
    answers = [None] * n
    for idx, status, body in rep["bodies"]:
        check(status == 200, f"S: request {idx} got {status}")
        answers[idx] = _unpng(body)
    for r in extra_reps:
        check(r["ok"] == 1, f"S: extra request {r}")
        answers.append(_unpng(r["bodies"][0][2]))
    return answers, rep, server.stats.summary(), launches, warmup_s, spans


def fault_counters(engine, images, bucket, plan, wait_s=60.0) -> tuple:
    """One batch of ``images`` through a 1-replica pool under ``plan`` ->
    (answers, the pool's counters once the replica is healthy again). The
    pool's supervisor is driven by hand after the batch (its own scans
    are an hour apart), as tests/test_torch_serving.py drives it, so the
    quarantine always follows the re-dispatched batch."""
    from waternet_tpu_torch.resilience import faults
    from waternet_tpu_torch.serving import BucketLadder, DynamicBatcher, SupervisionConfig

    b = DynamicBatcher(engine, BucketLadder([bucket]), max_batch=len(images), max_wait_ms=5,
                       supervision=SupervisionConfig(scan_interval_sec=3600, rewarm_backoff_sec=0.01))
    try:
        faults.install(faults.FaultPlan.parse(plan))
        outs = b.map_ordered(images)
        faults.clear()
        deadline = time.monotonic() + wait_s
        while time.monotonic() < deadline and not (
            b.stats.summary()["reintegrations"] >= 1
            and all(s == "healthy" for s in b.health()["quality"].values())
        ):
            b._pool._supervise_once()
            time.sleep(0.01)
        s = b.stats.summary()
    finally:
        faults.clear()
        b.close()
    return outs, {k: s[k] for k in FAULT_COUNTERS}


def run_serving(torch, dev, card) -> dict:
    """Phase 12 (S): the serving path on the card. Returns the launches
    of S1, S2 and S3, each counted from 0 around its requests."""
    from waternet_tpu_torch.bench import _serving_population
    from waternet_tpu_torch.inference_engine import InferenceEngine
    from waternet_tpu_torch.ops import kernels
    from waternet_tpu_torch.ops.masked import transform_masked_batch
    from waternet_tpu_torch.ops.transform import transform_batch
    from waternet_tpu_torch.serving import RECEPTIVE_RADIUS, derive_buckets
    from waternet_tpu_torch.utils.tensor import to_device

    images, shapes = _serving_population(SERVE["n"], SERVE["base"])
    ladder = derive_buckets(shapes, max_buckets=SERVE["max_buckets"])
    slots = SERVE["max_batch"]
    launches = {}

    # S1: fp32, host preprocessing.
    engine = InferenceEngine(weights=WEIGHTS, device=dev)
    s1, rep, stats, launches["serving_S1"], warmup_s, spans1 = serve_over_http(engine, ladder, images)
    check(launches["serving_S1"] == NO_LAUNCH, f"S1 launches {launches['serving_S1']}")
    check(stats["compiles"] == len(ladder) and stats["fallback_native_shapes"] == 0,
          f"S1 compiles {stats['compiles']}, fallbacks {stats['fallback_native_shapes']}")
    check(engine.cold_dispatches == 0, f"S1: {engine.cold_dispatches} cold dispatches")
    r = RECEPTIVE_RADIUS
    interior_max, interior_diff_px, interior_px, seam_psnr = 0, 0, 0, []
    for im, got in zip(images, s1):
        h, w = im.shape[:2]
        want = engine.enhance_padded([im], ladder.bucket_for(h, w), n_slots=slots)[0, :h, :w]
        check(np.array_equal(got, want), f"S1: a {h}x{w} response differs from enhance_padded")
        native = engine.enhance(im[None])[0]
        d = np.abs(got.astype(np.int16) - native.astype(np.int16))
        interior_max = max(interior_max, int(d[: h - r, : w - r].max()))
        interior_diff_px += int((d[: h - r, : w - r] > 0).sum())
        interior_px += d[: h - r, : w - r].size
        band = np.ones((h, w), bool)
        band[: h - r, : w - r] = False
        mse = float((d[band].astype(np.float64) ** 2).mean())
        seam_psnr.append(10 * np.log10(255.0**2 / max(mse, 1e-12)))
    check(engine.cold_dispatches == 0, "S1: enhance_padded met a cold shape")
    print(json.dumps({
        "run": "S1 serve fp32 host-preprocess", "images": len(images), "buckets": ladder.describe(),
        "max_batch": slots, "concurrency": SERVE["concurrency"], "warmup_sec": warmup_s,
        "http_images_per_sec": rep["images_per_sec"], "latency_ms": rep["latency_ms"],
        "batch_occupancy": stats["batch_occupancy"], "padding_overhead": stats["padding_overhead"],
        "compiles": stats["compiles"], "cold_dispatches": engine.cold_dispatches,
        "launches": launches["serving_S1"], "equals_enhance_padded": True,
        "interior_vs_native": {"max_abs_diff": interior_max,
                               "share_differing": interior_diff_px / interior_px},
        "seam_psnr_db_min": min(seam_psnr), "batches": stats["batches"],
        "replica_busy_sec": stats["per_replica"][0]["busy_sec"], "spans": spans1, "card": card,
    }), flush=True)

    # S2: bf16, device preprocessing; the masked transforms first.
    engine2 = InferenceEngine(weights=WEIGHTS, device_preprocess=True, device=dev, dtype=torch.bfloat16)
    for k in range(4):
        im = images[k]
        h, w = im.shape[:2]
        canvas, hw = engine2.pad_raw_to_bucket([im], ladder.bucket_for(h, w))
        masked = transform_masked_batch(to_device(torch.from_numpy(canvas), dev),
                                        to_device(torch.from_numpy(hw), dev))
        native = transform_batch(to_device(torch.from_numpy(im[None]), dev))
        for name, m, n in zip(("wb", "gc", "he"), masked, native):
            check(torch.equal(m[0, :h, :w], n[0]), f"S2: masked {name} != transform_batch at {h}x{w}")
    print(json.dumps({"run": "S2 masked transforms", "shapes": [list(im.shape[:2]) for im in images[:4]],
                      "equal_to_transform_batch": True, "card": card}), flush=True)
    oversize = oversize_frame(OVERSIZE_SEEDS["S2"])
    s2, rep2, stats2, launches["serving_S2"], warmup2_s, spans2 = serve_over_http(
        engine2, ladder, images, [oversize])
    want = dict(NO_LAUNCH, tile_lut=1, clahe_lut_planes=1)
    check(launches["serving_S2"] == want, f"S2 launches {launches['serving_S2']}, want {want}")
    check(stats2["fallback_native_shapes"] == 1 and stats2["compiles"] == len(ladder) + 1,
          f"S2 fallbacks {stats2['fallback_native_shapes']}, compiles {stats2['compiles']}")
    check(engine2.cold_dispatches == 0, f"S2: {engine2.cold_dispatches} cold dispatches")
    check(s2[-1].shape == oversize.shape and s2[-1].std() > 0, "S2: the oversize answer")
    # Within 13 px of the pad seam the two paths see other pad content by
    # design (the host pads the transformed image, the device equalizes
    # the padded canvas: ops/masked.py), so the bf16 bound holds on the
    # interior and the seam band's gap is printed beside it.
    d, seam = [], []
    for a, b in zip(s2[:-1], s1):
        h, w = b.shape[:2]
        diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
        d.append(diff[: h - r, : w - r].ravel())
        band = np.ones((h, w), bool)
        band[: h - r, : w - r] = False
        seam.append(diff[band].ravel())
    d, seam = np.concatenate(d), np.concatenate(seam)
    print(json.dumps({
        "run": "S2 serve bf16 device-preprocess", "warmup_sec": warmup2_s,
        "http_images_per_sec": rep2["images_per_sec"], "latency_ms": rep2["latency_ms"],
        "batch_occupancy": stats2["batch_occupancy"], "padding_overhead": stats2["padding_overhead"],
        "compiles": stats2["compiles"], "fallback_native_shapes": stats2["fallback_native_shapes"],
        "oversize": list(oversize.shape[:2]), "launches": launches["serving_S2"],
        "batches": stats2["batches"], "replica_busy_sec": stats2["per_replica"][0]["busy_sec"],
        "spans": spans2,
        "vs_S1_interior": {"max_abs_diff": int(d.max()), "share_over_1": float((d > 1).mean())},
        "vs_S1_seam_band": {"max_abs_diff": int(seam.max()), "share_over_1": float((seam > 1).mean())},
        "card": card,
    }), flush=True)
    check(d.max() <= BF16_LEVELS and (d > 1).mean() <= 0.01,
          f"S2 vs S1 interior: {int(d.max())} levels, {(d > 1).mean():.4%} over one")
    del engine2

    # S3: a fault plan on the card against the same plan on the CPU port.
    bucket = ladder.buckets[0]
    idx = [i for i, im in enumerate(images) if ladder.bucket_for(*im.shape[:2]) == bucket][:slots]
    cpu = InferenceEngine(weights=WEIGHTS, device="cpu")
    small = [np.ascontiguousarray(images[i][:40, :48]) for i in idx]
    faults_line = {}
    for plan in ("replica_crash@1", "nan_output@1"):
        kernels.reset_launches()
        outs, card_counts = fault_counters(engine, [images[i] for i in idx], bucket, plan)
        torch.cuda.synchronize()
        launches[f"serving_S3_{plan.split('@')[0]}"] = dict(kernels.LAUNCHES)
        for i, o in zip(idx, outs):
            check(np.array_equal(o, s1[i]), f"S3 {plan}: an answer differs from S1's")
        _, cpu_counts = fault_counters(cpu, small, (40, 48), plan)
        check(card_counts == cpu_counts, f"S3 {plan}: card counters {card_counts}, CPU {cpu_counts}")
        faults_line[plan] = card_counts
    check(all(v == NO_LAUNCH for k, v in launches.items() if k.startswith("serving_S3")),
          f"S3 launches {launches}")
    print(json.dumps({"run": "S3 fault plans", "batch": len(idx), "bucket": list(bucket),
                      "counters": faults_line, "equal_to_cpu_port": True, "answers_equal_S1": True,
                      "card": card}), flush=True)
    del engine, cpu
    torch.cuda.empty_cache()

    for config in ("serve", "serve_http"):
        line = run_bench(card, "--config", config)
        compiles = line["compiles_bucketed" if config == "serve" else "compiles"]
        check(compiles == len(line["buckets"]) and line["cold_dispatches"] == 0,
              f"bench {config}: compiles {compiles}, cold {line['cold_dispatches']}")
        if config == "serve_http":
            check(line["accounted"] is True, "bench serve_http: not accounted")
    return launches


def timed_p50(torch, fn, n: int = 5) -> tuple:
    """(p50 seconds, every run's seconds) of ``fn`` on the host clock, the
    card synchronised around each run."""
    lat = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    return statistics.median(lat), lat


def r1_run(torch, tag: str, engine, frames, card, **extra) -> dict:
    """One warm-up call, then the p50 of 5 of ``engine.enhance(frames)``
    with the peak memory and the launches of the timed calls (none on
    the student's path), and one more call under ``torch.profiler``
    (``stage_profile._profile``: device busy ms, idle share, the costliest
    kernels)."""
    from waternet_tpu_torch.ops import kernels
    from waternet_tpu_torch.stage_profile import _profile

    out = engine.enhance(frames)
    check(out.shape == frames.shape and out.dtype == np.uint8 and out.std() > 0, f"{tag}: output")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    p50, lat = timed_p50(torch, lambda: engine.enhance(frames))
    line = {"run": tag, "shape": list(frames.shape), "latency_ms_p50": p50 * 1e3,
            "latency_ms": [t * 1e3 for t in lat], "frames_per_s": len(frames) / p50,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(), "launches": dict(kernels.LAUNCHES),
            "profiled": _profile(lambda: engine.enhance(frames)), **extra, "card": card}
    print(json.dumps(line), flush=True)
    return line


def run_fast_tier(torch, dev, card) -> dict:
    """Phase 13 (F): the fast tier on the card. Returns the launches of
    F2's int8 request and F3's distillation, each counted from 0."""
    from waternet_tpu_torch.export import load_artifact, save_artifact
    from waternet_tpu_torch.hub import build_model, resolve_weights
    from waternet_tpu_torch.inference_engine import InferenceEngine, StudentEngine
    from waternet_tpu_torch.models import CANStudent, quant
    from waternet_tpu_torch.models.can import build_student, train_flops_per_image
    from waternet_tpu_torch.obs.device import peak_tflops
    from waternet_tpu_torch.ops import kernels
    from waternet_tpu_torch.ops.transform import transform_batch
    from waternet_tpu_torch.utils.synthetic import photo_frames
    from waternet_tpu_torch.utils.tensor import to_device

    rng = np.random.default_rng(SEED + 13)
    r1 = photo_frames(rng, *REQUESTS["R1"])
    r3 = photo_frames(rng, *REQUESTS["R3"])
    launches = {}

    # F1: the default 24 x 7 student (seeded) at R1, fp32 and bf16; no launch.
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        default_student = CANStudent().state_dict()
    for dtype, name in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        eng = StudentEngine(params=default_student, dtype=dtype, device=dev)
        line = r1_run(torch, f"F1 student 24x7 {name} R1", eng, r1, card)
        check(line["launches"] == NO_LAUNCH, f"F1 {name}: launches {line['launches']}")
        del eng
    # The fixture student on the card against the CPU port's, at R3.
    card_eng = StudentEngine(weights=STUDENT, device=dev)
    cpu_eng = StudentEngine(weights=STUDENT, device="cpu")
    got = card_eng.enhance_async(r3).cpu()
    want = cpu_eng.enhance_async(r3)
    f_err = float((got - want).abs().max())
    d = np.abs(card_eng.enhance(r3).astype(np.int16) - cpu_eng.enhance(r3).astype(np.int16))
    print(json.dumps({"run": "F1 fixture student card vs CPU R3", "max_abs_err_fp32": f_err,
                      "uint8_max_abs_diff": int(d.max()), "share_differing": float((d > 0).mean()),
                      "card": card}), flush=True)
    check(f_err <= FAST_ATOL and d.max() <= 1, f"F1: card vs CPU {f_err} fp32, {int(d.max())} levels")
    del card_eng, cpu_eng

    # F2: int8. The CPU port's int8 engine calibrates the qtree; the card's
    # takes the same qtree. Every conv's int32 accumulators equal on the
    # same network inputs (the card's transforms), and the answers of the
    # two engines within one level.
    cpu_q = InferenceEngine(weights=WEIGHTS, device_preprocess=True, device="cpu", quantize=True)
    card_q = InferenceEngine(params=cpu_q.params, device_preprocess=True, device=dev, quantize=True)
    card_q.enhance(r3)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    out_card = card_q.enhance(r3)
    torch.cuda.synchronize()
    launches["fast_F2_int8_request"] = dict(kernels.LAUNCHES)
    want_l = dict(NO_LAUNCH, tile_lut=1, clahe_lut_planes=1)
    check(launches["fast_F2_int8_request"] == want_l, f"F2 launches {launches['fast_F2_int8_request']}")
    d = np.abs(out_card.astype(np.int16) - cpu_q.enhance(r3).astype(np.int16))
    rgb = to_device(torch.from_numpy(r3), dev)
    wb, gc, he = transform_batch(rgb)
    planes = [rgb.to(torch.float32) / 255.0, wb / 255.0, he / 255.0, gc / 255.0]
    accs_card, accs_cpu = {}, {}
    card_q.model.acc_hook = lambda n, a: accs_card.__setitem__(n, a.cpu())
    cpu_q.model.acc_hook = accs_cpu.__setitem__
    q_card = card_q.forward(*planes).cpu()
    q_cpu = cpu_q.forward(*(p.cpu() for p in planes))
    card_q.model.acc_hook = None
    unequal = sorted(n for n in accs_cpu if not torch.equal(accs_card[n], accs_cpu[n]))
    print(json.dumps({"run": "F2 int8 R3 card vs CPU", "convs": len(accs_cpu), "accumulators_unequal": unequal,
                      "forward_max_abs_err": float((q_card - q_cpu).abs().max()),
                      "answers_max_abs_diff": int(d.max()), "answers_share_differing": float((d > 0).mean()),
                      "launches": launches["fast_F2_int8_request"], "card": card}), flush=True)
    check(len(accs_cpu) == 17 and not unequal, f"F2: accumulators differ at {unequal}")
    check(d.max() <= 1, f"F2: int8 answers differ from the CPU port's by {int(d.max())} levels")
    calibrated_on_card(torch, dev, card, r3, cpu_q)
    del cpu_q
    widest = {"k": 128 * 5 * 5, "band_rows": quant.band_rows(*REQUESTS["R1"], 128 * 5 * 5),
              "budget_bytes": quant.IM2COL_BUDGET_BYTES}
    r1_run(torch, "F2 int8 quality R1", card_q, r1, card, im2col_widest=widest)
    del card_q
    torch.cuda.empty_cache()
    stu_q = StudentEngine(params=default_student, quantize=True, device=dev)
    r1_run(torch, "F2 int8 student 24x7 R1", stu_q, r1, card,
           im2col_widest={"k": 24 * 9, "band_rows": quant.band_rows(*REQUESTS["R1"], 24 * 9)})
    del stu_q
    torch.cuda.empty_cache()

    # F3: distillation through the train CLI at the JAX CLI's default.
    f3 = FAST_DISTILL
    with tempfile.TemporaryDirectory() as keep:
        stats, config, _ = train_cli("F3 distill", [
            "--distill", "--teacher-weights", WEIGHTS, "--synthetic", str(f3["synthetic"]),
            "--val-size", str(f3["val_size"]), "--epochs", "2", "--batch-size", str(f3["batch"]),
            "--height", str(f3["hw"]), "--width", str(f3["hw"]), "--precision", "bf16"], keep=keep)
        check(config["distill"] is True and (config["student_width"], config["student_depth"]) == (24, 7),
              f"F3 config {config}")
        check(stats[1]["train"]["loss"] < stats[0]["train"]["loss"],
              f"F3: train loss {stats[0]['train']['loss']} -> {stats[1]['train']['loss']}")
        totals = {}
        from waternet_tpu_torch.data.synthetic import synthetic_split

        train_idx, val_idx = synthetic_split(f3["synthetic"], f3["val_size"])
        n_train, n_val = -(-len(train_idx) // f3["batch"]), -(-len(val_idx) // f3["batch"])
        for s in stats:
            check_launches("F3", s, {"train": (CLAHE_ONLY, n_train), "val": (CLAHE_ONLY, n_val)}, totals)
        launches["fast_F3_distill"] = totals
        ips = stats[1]["train_images_per_s"]
        peak = peak_tflops(dev, "bf16")
        mfu = ips * train_flops_per_image(f3["hw"], f3["hw"], 24, 7, distill=True) / 1e12 / peak
        served = StudentEngine(weights=str(Path(keep) / "last.npz"), device=dev).enhance(r3)
        check(served.shape == r3.shape and served.std() > 0, "F3: the distilled student's answer")
    print(json.dumps({"run": "F3 distill CLI", "steps_per_epoch": n_train, "warm_images_per_s": ips,
                      "warm_step_ms": stats[1]["step_ms"], "mfu": mfu, "peak_mem_bytes": stats[1]["peak_mem_bytes"],
                      "train_loss": [s["train"]["loss"] for s in stats],
                      "val_ssim_vs_teacher": [s["val"]["ssim"] for s in stats], "launches": totals,
                      "served_by_student_engine": True, "card": card}), flush=True)

    # F4: two-tier serving on phase 12's population, fp32.
    launches.update(run_two_tier(torch, dev, card))

    # F5: the export artifacts on the card, against the eager forward.
    s_sd, t_sd = resolve_weights(STUDENT), resolve_weights(WEIGHTS)
    gen = torch.Generator(dev).manual_seed(SEED)
    with tempfile.TemporaryDirectory() as d5:
        for tag, params, arch, q in (("student float", s_sd, "can", False), ("student int8", s_sd, "can", True),
                                     ("waternet float", t_sd, "waternet", False)):
            t0 = time.perf_counter()
            run = load_artifact(save_artifact(Path(d5) / tag.replace(" ", "_"), params, arch=arch, quantize=q,
                                              device=dev))
            export_s = time.perf_counter() - t0
            if arch == "can":
                # Host calibration, as the artifact's (export.py).
                eager = quant.QuantCAN(quant.quantize_can(params, device="cpu"), dev) if q else build_student(params, dev)
            else:
                eager = build_model(params, dev)
            errs = []
            for shape in (REQUESTS["R3"], REQUESTS["R2"]):
                xs = [torch.rand((*shape, 3), device=dev, generator=gen) for _ in range(1 if arch == "can" else 4)]
                with torch.inference_mode():
                    want = eager(*xs)
                errs.append(float((run(*xs) - want).abs().max()))
            print(json.dumps({"run": f"F5 export {tag}", "export_and_load_s": export_s,
                              "shapes": [list(REQUESTS["R3"]), list(REQUESTS["R2"])], "max_abs_err": errs,
                              "tolerance": 0.0, "card": card}), flush=True)
            check(max(errs) == 0.0, f"F5 {tag}: artifact differs from the eager forward by {errs}")
    torch.cuda.empty_cache()

    # F6: the bench's fast-tier line and the int8 video arm, side by side
    # (they share the card; neither's time is compared).
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:
        tiers = pool.submit(run_bench, card, "--config", "tiers")
        # 8 timed calls: the int8 line's ~0.8 s a call is measured, not averaged.
        video = pool.submit(run_bench, card, "--config", "video",
                            env={"WATERNET_QUANT": "1", "WATERNET_BENCH_WARMUP": "1", "WATERNET_BENCH_STEPS": "8"})
        tiers, video = tiers.result(), video.result()
    check(tiers["compiles"] == 2 * len(tiers["buckets"]) and tiers["cold_dispatches"] == 0,
          f"bench tiers: compiles {tiers['compiles']}, cold {tiers['cold_dispatches']}")
    check(video["quantized"] is True and video["precision"] == "int8", f"bench video int8: {video}")
    return launches



def calibrated_on_card(torch, dev, card, r3, cpu_q) -> None:
    """F2b: ``InferenceEngine(quantize=True)`` and ``StudentEngine(quantize=
    True)`` built for the card (their calibration runs on the host), against
    the CPU port's qtrees: every conv's input scale equal, and the answers
    at R3 within one level; each engine's construction seconds (the host
    calibration) printed."""
    from waternet_tpu_torch.inference_engine import InferenceEngine, StudentEngine
    from waternet_tpu_torch.models import quant

    def scale_gaps(card_tree, cpu_tree):
        return {f"{branch}/{i}": abs(float(a["s_in"]) - float(b["s_in"])) / float(b["s_in"])
                for branch in cpu_tree for i, (a, b) in enumerate(zip(card_tree[branch], cpu_tree[branch]))}

    def level_gap(a, b):
        d = np.abs(a.astype(np.int16) - b.astype(np.int16))
        return {"max_abs_diff": int(d.max()), "share_differing": float((d > 0).mean()),
                "share_over_1": float((d > 1).mean())}

    def build(make):
        t0 = time.perf_counter()
        engine = make()
        return engine, time.perf_counter() - t0

    engines = {"quality": (*build(lambda: InferenceEngine(weights=WEIGHTS, device_preprocess=True, device=dev,
                                                          quantize=True)), cpu_q),
               "student": (*build(lambda: StudentEngine(weights=STUDENT, quantize=True, device=dev)),
                           StudentEngine(weights=STUDENT, quantize=True, device="cpu"))}
    for name, (on_card, build_s, on_cpu) in engines.items():
        gaps = scale_gaps(on_card.params, on_cpu.params)
        worst = max(gaps, key=gaps.get)
        answers = level_gap(on_card.enhance(r3), on_cpu.enhance(r3))
        line = {"run": f"F2b int8 {name} built for the card, calibrated on the host", "convs": len(gaps),
                "scales_equal": sum(g == 0.0 for g in gaps.values()), "max_rel_scale_gap": gaps[worst],
                "worst_layer": worst, "rel_scale_gap": gaps, "engine_build_s": build_s,
                "answers_vs_cpu_port_R3": answers, "card": card}
        print(json.dumps(line), flush=True)
        check(all(g == 0.0 for g in gaps.values()), f"F2b {name}: scales differ from the CPU port's: {gaps}")
        check(answers["max_abs_diff"] <= 1, f"F2b {name}: answers {answers['max_abs_diff']} levels from the CPU port's")
    # The card's int8 student on its own (host-calibrated) qtree: its int32
    # accumulators against the CPU port's on the same float input.
    stu_card, _, stu_cpu = engines["student"]
    x = torch.from_numpy(r3).to(torch.float32) / 255.0
    accs_card, accs_cpu = {}, {}
    quant.QuantCAN(stu_card.params, dev, acc_hook=lambda n, a: accs_card.__setitem__(n, a.cpu()))(x.to(dev))
    quant.QuantCAN(stu_cpu.params, "cpu", acc_hook=accs_cpu.__setitem__)(x)
    unequal = sorted(n for n in accs_cpu if not torch.equal(accs_card[n], accs_cpu[n]))
    print(json.dumps({"run": "F2b int8 student accumulators, card against the CPU port", "convs": len(accs_cpu),
                      "accumulators_unequal": unequal, "card": card}), flush=True)
    check(not unequal, f"F2b: the student's int32 accumulators differ at {unequal}")
    del engines, stu_card
    torch.cuda.empty_cache()

def run_two_tier(torch, dev, card) -> dict:
    """F4: a two-tier ``ServingServer`` (the teacher fp32 with host
    preprocessing, the fixture student fp32) on phase 12's population;
    returns its launches (none)."""
    from waternet_tpu_torch.bench import _serving_population
    from waternet_tpu_torch.inference_engine import InferenceEngine, StudentEngine
    from waternet_tpu_torch.ops import kernels
    from waternet_tpu_torch.serving import derive_buckets
    from waternet_tpu_torch.serving.loadgen import run_load
    from waternet_tpu_torch.serving.server import ServingServer

    images, shapes = _serving_population(SERVE["n"], SERVE["base"])
    ladder = derive_buckets(shapes, max_buckets=SERVE["max_buckets"])
    slots, n = SERVE["max_batch"], len(images)
    quality = InferenceEngine(weights=WEIGHTS, device=dev)
    fast = StudentEngine(weights=STUDENT, device=dev)
    server = ServingServer(quality, ladder, max_batch=slots, max_wait_ms=5.0, replicas=1, max_queue=256,
                           fast_engine=fast)
    pngs = [_png(im) for im in images]
    t0 = time.perf_counter()
    server.start_background(timeout=60)
    try:
        server.wait_ready(timeout=300)
        warmup_s = time.perf_counter() - t0
        compiles = server.stats.summary()["compiles"]
        kernels.reset_launches()
        rep_f = run_load(server.url, pngs, concurrency=SERVE["concurrency"], total=n, keep_bodies=True, tier="fast")
        rep_q = run_load(server.url, pngs, concurrency=SERVE["concurrency"], total=n, keep_bodies=False)
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", server.bound_port, timeout=60)
        conn.request("POST", "/admin/policy", body=json.dumps({"downgrade_watermark": 1}).encode())
        resp = conn.getresponse()
        policy = json.loads(resp.read())
        conn.close()
        check(resp.status == 200 and policy["policy"]["downgrade_watermark"] == 1, f"F4 policy {policy}")
        # Keep the quality backlog above the watermark while the opted-in
        # requests arrive: every one of them must be downgraded.
        held = [server.batcher.submit(im) for im in images]
        rep_d = run_load(server.url, pngs[:slots * 2], concurrency=SERVE["concurrency"], total=slots * 2,
                         keep_bodies=True, tier="quality", allow_downgrade=True)
        still_held = sum(not h.done() for h in held)
        for h in held:
            h.result(timeout=300)
        launches = dict(kernels.LAUNCHES)
        stats = server.stats.summary()
    finally:
        server.request_drain()
        code = server.join(timeout=300)
    check(code == 0, f"F4: the server's drain exited {code}")
    check(compiles == 2 * len(ladder) == stats["compiles"], f"F4 compiles {compiles} / {stats['compiles']}")
    check(quality.cold_dispatches == 0 and fast.cold_dispatches == 0, "F4: a cold dispatch")
    check(launches == NO_LAUNCH, f"F4 launches {launches}")
    for rep in (rep_f, rep_q, rep_d):
        check(rep["ok"] == rep["sent"] and rep["errors"] == 0, f"F4 load report {rep}")
    fast_want = {}
    for i, im in enumerate(images):
        h, w = im.shape[:2]
        fast_want[i] = fast.enhance_padded([im], ladder.bucket_for(h, w), n_slots=slots)[0, :h, :w]
    for idx, status, body in rep_f["bodies"]:
        check(np.array_equal(_unpng(body), fast_want[idx]), f"F4: fast answer {idx} differs from enhance_padded")
    check(rep_d["downgraded"] == rep_d["sent"] and still_held > 0,
          f"F4: {rep_d['downgraded']} of {rep_d['sent']} downgraded ({still_held} held still queued)")
    for idx, status, body in rep_d["bodies"]:
        check(np.array_equal(_unpng(body), fast_want[idx]), f"F4: downgraded answer {idx} differs from the fast tier's")
    print(json.dumps({
        "run": "F4 two-tier serve fp32", "images": n, "buckets": ladder.describe(), "max_batch": slots,
        "warmup_sec": warmup_s, "compiles": stats["compiles"], "cold_dispatches": 0,
        "fast_images_per_sec": rep_f["images_per_sec"], "fast_latency_ms": rep_f["latency_ms"],
        "quality_images_per_sec": rep_q["images_per_sec"], "quality_latency_ms": rep_q["latency_ms"],
        "downgraded": rep_d["downgraded"], "of": rep_d["sent"], "stats_downgraded": stats["downgraded"],
        "tiers": stats["tiers"], "fast_equals_enhance_padded": True, "launches": launches, "card": card,
    }), flush=True)
    return {"fast_F4_serving": launches}


def open_stream(port: int, headers: dict, timeout: float = 120.0):
    """``POST /stream`` on a raw socket -> (socket, reader, status, head)."""
    import socket

    sock = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    lines = ["POST /stream HTTP/1.1", f"Host: 127.0.0.1:{port}"] + [f"{k}: {v}" for k, v in headers.items()]
    sock.sendall(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1"))
    f = sock.makefile("rb")
    status = int(f.readline().split()[1])
    head = {}
    while True:
        line = f.readline()
        if not line or line in (b"\r\n", b"\n"):
            break
        k, _, v = line.decode("latin-1").partition(":")
        head[k.strip().lower()] = v.strip()
    return sock, f, status, head


def send_frames(sock, payloads, gap_s: float = 0.0) -> None:
    """Each payload as one length-prefixed frame, then the clean end."""
    from waternet_tpu_torch.serving.streams import FRAME_LEN

    for p in payloads:
        sock.sendall(FRAME_LEN.pack(len(p)) + p)
        if gap_s:
            time.sleep(gap_s)
    sock.sendall(FRAME_LEN.pack(0))


def read_records(f) -> list:
    """Every record of a session up to its ``Z`` summary: (kind, flags,
    seq, payload)."""
    from waternet_tpu_torch.serving.streams import KIND_END, REC_HEAD

    recs = []
    while True:
        head = f.read(REC_HEAD.size)
        if len(head) < REC_HEAD.size:
            break
        kind, flags, seq, n = REC_HEAD.unpack(head)
        recs.append((kind, flags, seq, f.read(n) if n else b""))
        if kind == KIND_END:
            break
    return recs


def stream_session(port: int, payloads, headers: dict, gap_s: float = 0.0) -> tuple:
    """One whole stream session -> (status, head, records)."""
    sock, f, status, head = open_stream(port, headers)
    try:
        if status == 200:
            send_frames(sock, payloads, gap_s)
            return status, head, read_records(f)
        return status, head, []
    finally:
        sock.close()


def run_streams(torch, dev, card) -> dict:
    """Phase 14 (St), its stream half: one ``ServingServer`` (the bf16
    quality engine with device preprocessing, the fixture student bf16 as
    the fast tier, phase 12's ladder) answering stream sessions. Returns
    the launches of the bucketed streams and of the oversize frame, and
    the path of the trace it wrote."""
    import os

    from waternet_tpu_torch.bench import _serving_population
    from waternet_tpu_torch.inference_engine import InferenceEngine, StudentEngine
    from waternet_tpu_torch.obs import trace
    from waternet_tpu_torch.ops import kernels
    from waternet_tpu_torch.resilience import faults
    from waternet_tpu_torch.serving import derive_buckets
    from waternet_tpu_torch.serving.loadgen import run_stream_load
    from waternet_tpu_torch.serving.server import ServingServer
    from waternet_tpu_torch.serving.streams import FLAG_DOWNGRADED, FLAG_REUSED, FRAME_LEN

    st = STREAMS
    images, shapes = _serving_population(SERVE["n"], SERVE["base"])
    ladder = derive_buckets(shapes, max_buckets=SERVE["max_buckets"])
    slots = SERVE["max_batch"]
    quality = InferenceEngine(weights=WEIGHTS, device_preprocess=True, device=dev, dtype=torch.bfloat16)
    fast = StudentEngine(weights=STUDENT, device=dev, dtype=torch.bfloat16)
    pngs = [_png(im) for im in images]
    server = ServingServer(quality, ladder, max_batch=slots, max_wait_ms=5.0, replicas=1, max_queue=256,
                           fast_engine=fast, max_streams=8, stream_window=8)
    launches, out = {}, {}
    t0 = time.perf_counter()
    server.start_background(timeout=60)
    try:
        server.wait_ready(timeout=300)
        out["warmup_sec"] = time.perf_counter() - t0
        port = server.bound_port
        cold0 = quality.cold_dispatches + fast.cold_dispatches
        compiles0 = server.stats.summary()["compiles"]
        want_q = [quality.enhance_padded([im], ladder.bucket_for(*im.shape[:2]), n_slots=slots)[0, :im.shape[0],
                                                                                               :im.shape[1]]
                  for im in images]

        # (a) Delivery and exactness: 3 paced streams of 24 frames, traced.
        kernels.reset_launches()
        trace.reset()
        trace.enable()
        try:
            rep = run_stream_load(server.url, pngs, streams=st["streams"], frames=st["frames"], fps=st["fps"],
                                  budget_ms=60_000.0, window=st["frames"], keep_frames=True)
        finally:
            trace.disable()
        torch.cuda.synchronize()
        launches["streams_St_bucketed"] = dict(kernels.LAUNCHES)
        trace_path = Path(tempfile.mkdtemp(prefix="chip-smoke-trace-")) / "streams.json"
        trace.export(str(trace_path))
        n = st["streams"] * st["frames"]
        check(rep["ok"] == n and rep["frames_sent"] == n and rep["errors"] == 0 and rep["conn_reset"] == 0,
              f"St(a): stream report {({k: rep[k] for k in ('ok', 'dropped', 'out_of_budget', 'errors')})}")
        for si, recs in rep["frames"].items():
            check([r[0] for r in recs] == list(range(st["frames"])), f"St(a): stream {si} out of order")
            for seq, kind, body in recs:
                check(kind == "F" and np.array_equal(_unpng(body), want_q[seq % len(images)]),
                      f"St(a): stream {si} frame {seq} differs from enhance_padded")
        check(launches["streams_St_bucketed"] == NO_LAUNCH, f"St(b): bucketed launches {launches}")
        s_a = server.stats.summary()
        check(s_a["compiles"] == compiles0 and s_a["fallback_native_shapes"] == 0
              and quality.cold_dispatches + fast.cold_dispatches == cold0 == 0,
              f"St(a): compiles {compiles0} -> {s_a['compiles']}, cold {cold0}")
        out["a"] = {"frames": n, "fps_per_stream": rep["fps_per_stream"], "offered_fps": st["fps"],
                    "frame_latency_ms": rep["frame_latency_ms"], "equal_to_enhance_padded": True,
                    "in_order": True}

        # (b) One oversize frame: the native fallback launches each CLAHE kernel once.
        oversize = oversize_frame(OVERSIZE_SEEDS["St"])
        bh, bw = oversize.shape[:2]
        kernels.reset_launches()
        status, _, recs = stream_session(port, [_png(oversize)], {"X-Stream-Budget-Ms": "60000"})
        torch.cuda.synchronize()
        launches["streams_St_oversize"] = dict(kernels.LAUNCHES)
        check(status == 200 and [r[0] for r in recs] == [b"F", b"Z"], f"St(b): oversize records {[r[:3] for r in recs]}")
        check(np.array_equal(_unpng(recs[0][3]), quality.enhance(oversize[None])[0]),
              "St(b): the oversize frame differs from enhance at its native shape")
        check(launches["streams_St_oversize"] == CLAHE_ONLY, f"St(b): oversize launches {launches}")
        out["b"] = {"oversize": [bh, bw], "launches": launches["streams_St_oversize"],
                    "bucketed_launches": launches["streams_St_bucketed"]}

        # (e) Reuse: a static clip at delta 0 -> R records, byte for byte the recompute.
        k = st["reuse_frames"]
        status, _, recs = stream_session(port, [pngs[0]] * k, {"X-Stream-Budget-Ms": "60000", "X-Stream-Reuse": "0"})
        kinds = [r[0] for r in recs[:-1]]
        check(status == 200 and kinds == [b"F"] + [b"R"] * (k - 1), f"St(e): records {kinds}")
        check(all(r[1] == FLAG_REUSED and r[3] == recs[0][3] for r in recs[1:-1]), "St(e): an R record differs")
        check(np.array_equal(_unpng(recs[0][3]), want_q[0]), "St(e): the anchor differs from enhance_padded")
        out["e"] = {"frames": k, "reused": k - 1, "byte_identical": True}

        # (c) Isolation: a stalled session beside a healthy paced one; then frame_corrupt@K.
        os.environ["WATERNET_FAULT_STALL_SEC"] = str(st["stall_sec"])
        faults.install(faults.FaultPlan.parse("stream_stall@1"))
        try:
            sock, f, status, _ = open_stream(port, {"X-Stream-Window": "2", "X-Stream-Budget-Ms": "60000"})
            check(status == 200, f"St(c): stalled session status {status}")
            for p in pngs[:6]:
                sock.sendall(FRAME_LEN.pack(len(p)) + p)
            healthy = run_stream_load(server.url, pngs[:6], streams=1, frames=6, fps=st["fps"],
                                      budget_ms=st["budget_ms"], window=8)
            sock.sendall(FRAME_LEN.pack(0))
            stalled = read_records(f)
            sock.close()
        finally:
            faults.clear()
            os.environ.pop("WATERNET_FAULT_STALL_SEC", None)
        z = json.loads(stalled[-1][3])
        check(healthy["ok"] == 6 and healthy["frame_latency_ms"]["p99"] <= st["budget_ms"],
              f"St(c): the healthy stream {healthy['ok']} ok, p99 {healthy['frame_latency_ms']['p99']} ms")
        check(z["delivered"] + z["dropped"] == 6 and z["errors"] == 0, f"St(c): the stalled session {z}")
        kk = st["corrupt_at"]
        faults.install(faults.FaultPlan.parse(f"frame_corrupt@{kk}"))
        try:
            status, _, recs = stream_session(port, pngs[:6], {"X-Stream-Budget-Ms": "60000"})
        finally:
            faults.clear()
        kinds = [r[0] for r in recs[:-1]]
        check(kinds == [b"E" if i == kk - 1 else b"F" for i in range(6)], f"St(c): frame_corrupt records {kinds}")
        out["c"] = {"healthy_p99_ms": healthy["frame_latency_ms"]["p99"], "budget_ms": st["budget_ms"],
                    "stalled_summary": z, "stall_sec": st["stall_sec"], "corrupt_at": kk,
                    "error_seq": kk - 1}

        # (d) Brown-out: quality backlog held above watermark 1; an opted-in stream's frames downgrade.
        want_f = [fast.enhance_padded([im], ladder.bucket_for(*im.shape[:2]), n_slots=slots)[0, :im.shape[0], :im.shape[1]]
                  for im in images[:4]]
        server.batcher.downgrade_watermark = 1
        held = [server.batcher.submit(im) for im in images]
        status, _, recs = stream_session(port, pngs[:4], {"X-Tier": "quality", "X-Tier-Allow-Downgrade": "1",
                                                           "X-Stream-Budget-Ms": "60000"})
        still_held = sum(not h.done() for h in held)
        for h in held:
            h.result(timeout=300)
        server.batcher.downgrade_watermark = server.downgrade_watermark
        frames = recs[:-1]
        check(status == 200 and [r[0] for r in frames] == [b"F"] * 4, f"St(d): records {[r[:3] for r in frames]}")
        check(all(r[1] & FLAG_DOWNGRADED for r in frames), f"St(d): flags {[r[1] for r in frames]}")
        for _, _, seq, body in frames:
            check(np.array_equal(_unpng(body), want_f[seq]), f"St(d): downgraded frame {seq} differs from the student's")
        out["d"] = {"frames": 4, "downgraded": 4, "held_still_queued_after": still_held,
                    "equal_to_student_enhance_padded": True}

        stats = server.stats.summary()
        cold = quality.cold_dispatches + fast.cold_dispatches
    finally:
        server.request_drain()
        code = server.join(timeout=300)
    check(code == 0, f"St: the server's drain exited {code}")
    # The oversize frame is the one native shape: one entry, met once.
    check(stats["compiles"] == compiles0 + 1 and stats["fallback_native_shapes"] == 1,
          f"St: compiles {compiles0} -> {stats['compiles']}, fallbacks {stats['fallback_native_shapes']}")
    check(cold == cold0 == 0, f"St: cold dispatches {cold0} -> {cold}")
    print(json.dumps({"run": "St streams", **out, "compiles": stats["compiles"], "cold_dispatches": cold,
                      "streams_counters": stats["streams"], "trace": str(trace_path), "card": card}), flush=True)
    return launches, trace_path


def gpu_used_mib() -> int:
    """The card's used device memory in MiB, as nvidia-smi reads it (its
    per-process list need not name processes of a container's PID
    namespace)."""
    proc = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits", "-i", "0"],
                          capture_output=True, text=True, timeout=30)
    return int(proc.stdout.split()[0])


def rss_mib(pid: int):
    try:
        for line in Path(f"/proc/{pid}/status").read_text().splitlines():
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024
    except OSError:
        return None
    return None


def run_fleet(torch, dev, card) -> dict:
    """Phase 14 (St), its fleet half: ``FLEET["workers"]`` ``python -m
    waternet_tpu_torch.serving.server`` processes on the card (bf16,
    device preprocessing, phase 12's ladder) behind the fleet router, with
    ``gateway_crash@1`` on worker 0. Returns the worker's start-up and
    failover numbers."""
    import http.client

    from waternet_tpu_torch.bench import _serving_population
    from waternet_tpu_torch.resilience.heartbeat import read_heartbeat
    from waternet_tpu_torch.serving import derive_buckets
    from waternet_tpu_torch.serving.fleet import FleetRouter, worker_id

    fl = FLEET
    images, shapes = _serving_population(SERVE["n"], SERVE["base"])
    ladder = derive_buckets(shapes, max_buckets=SERVE["max_buckets"])
    pngs = [_png(im) for im in images[:fl["requests"]]]
    cmd = [sys.executable, "-m", "waternet_tpu_torch.serving.server", "--device", dev.type, "--weights", WEIGHTS,
           "--precision", "bf16", "--device-preprocess", "--serve-buckets", ",".join(ladder.describe()),
           "--max-batch", str(SERVE["max_batch"]), "--max-wait-ms", "5", "--serve-replicas", "1"]
    hb_root = Path(tempfile.mkdtemp(prefix="chip-smoke-fleet-"))
    router = FleetRouter(cmd, n_workers=fl["workers"], port=0, heartbeat_root=hb_root,
                         worker_faults={(0, 0): "gateway_crash@1"}, startup_grace_sec=fl["startup_grace_sec"],
                         heartbeat_sec=0.25, poll_sec=0.05, health_poll_sec=0.1, late_sec=5.0, hang_sec=30.0,
                         drain_grace_sec=10.0, backoff_base_sec=0.1, backoff_cap_sec=0.5)

    def request(body, rid):
        conn = http.client.HTTPConnection("127.0.0.1", router.bound_port, timeout=300)
        try:
            t0 = time.perf_counter()
            conn.request("POST", "/enhance", body=body, headers={"X-Request-Id": rid})
            resp = conn.getresponse()
            data = resp.read()
            return resp.status, {k.lower(): v for k, v in resp.getheaders()}, data, time.perf_counter() - t0
        finally:
            conn.close()

    def first_serve_beats(deadline_s):
        """Seconds from each worker's spawn to its first serve-phase beat."""
        seen, t_end = {}, time.monotonic() + deadline_s
        while time.monotonic() < t_end:
            with router._lock:
                ws = list(router._workers.values())
            for w in ws:
                beat = read_heartbeat(w.hb_file)
                if w.worker_id not in seen and beat is not None and beat.get("phase") == "serve":
                    seen[w.worker_id] = {"startup_to_serve_beat_s": beat["time"] - w.health.started_at,
                                         "pid": w.proc.pid}
            if len(seen) >= len(ws) and ws and all(w.ready for w in ws):
                return seen
            time.sleep(0.05)
        return seen

    torch.cuda.empty_cache()
    out = {"device_mib_before": gpu_used_mib()}
    t0 = time.perf_counter()
    router.start_background(timeout=60)
    try:
        beats = first_serve_beats(fl["startup_grace_sec"])
        router.wait_ready(timeout=60)
        out["fleet_ready_s"] = time.perf_counter() - t0
        check(len(beats) == fl["workers"], f"St(f): serve-phase beats from {sorted(beats)}")
        # The workers' device memory together: the card's use now, less before.
        out["device_mib_workers"] = gpu_used_mib() - out["device_mib_before"]
        for wid, b in beats.items():
            b["rss_mib"] = rss_mib(b["pid"])
        out["workers"] = beats
        # The first request of an idle fleet goes to slot 0, whose plan
        # SIGKILLs it on arrival: the router re-dispatches to slot 1.
        status, head, body, failover_s = request(pngs[0], "chip-smoke-failover")
        check(status == 200 and head.get("x-request-id") == "chip-smoke-failover"
              and head.get("x-worker-id") == worker_id(1, 0),
              f"St(f): failover answer {status} {head}")
        deadline = time.monotonic() + fl["startup_grace_sec"]
        while time.monotonic() < deadline:
            s = router.summary()
            if s["fleet"]["ready"] == fl["workers"] and worker_id(0, 1) in s["workers"]:
                break
            time.sleep(0.1)
        s = router.summary()
        check(worker_id(0, 1) in s["workers"] and s["fleet"]["restarts"] >= 1 and s["fleet"]["ready"] == fl["workers"],
              f"St(f): no relaunch {s['fleet']}")
        # Byte identity across the hop: the same payload from every live worker.
        answers = {}
        for i in range(4 * fl["workers"]):
            st_, hd, bd, _ = request(pngs[0], f"chip-smoke-identity-{i}")
            check(st_ == 200 and hd.get("x-worker-id"), f"St(f): identity request {st_} {hd}")
            answers.setdefault(hd["x-worker-id"], bd)
        check(all(bd == body for bd in answers.values()), f"St(f): answers differ across workers {sorted(answers)}")
        for i, p in enumerate(pngs[1:]):
            st_, hd, _, _ = request(p, f"chip-smoke-r{i}")
            check(st_ == 200 and hd.get("x-request-id") == f"chip-smoke-r{i}" and hd.get("x-worker-id"),
                  f"St(f): request {i}: {st_} {hd}")
        out.update({"failover_request_s": failover_s, "recovery_sec": s["fleet"]["recovery_sec_max"],
                    "redispatches": s["fleet"]["redispatches"], "restarts": s["fleet"]["restarts"],
                    "answered_by": sorted(answers), "byte_identical_across_workers": True,
                    "per_worker": s["fleet"]["per_worker"]})
    finally:
        router.request_drain()
        rc = router.join(timeout=300)
        shutil.rmtree(hb_root, ignore_errors=True)
    out["drain_rc"] = rc
    print(json.dumps({"run": "St fleet", **out, "card": card}), flush=True)
    return out


def run_streams_fleet(torch, dev, card) -> dict:
    """Phase 14 (St): streams, the fleet, the trace CLI and the two benches."""
    launches, trace_path = run_streams(torch, dev, card)
    torch.cuda.empty_cache()
    run_fleet(torch, dev, card)
    # (g) The trace CLI on the trace (a) wrote.
    proc = subprocess.run([sys.executable, "-m", "waternet_tpu_torch.obs.cli", str(trace_path)], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    check(proc.returncode == 0 and "per-stage latency" in proc.stdout and "stream_frame" in proc.stdout,
          f"St(g): trace CLI rc {proc.returncode}:\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    print(json.dumps({"run": "St trace CLI", "rc": proc.returncode, "lines": proc.stdout.count("\n"),
                      "card": card}), flush=True)
    print(proc.stdout[:3000], flush=True)
    shutil.rmtree(trace_path.parent, ignore_errors=True)
    # (h) The bench's stream and fleet lines, at a reduced size, side by
    # side (they share the card; neither's time is compared).
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:
        stream = pool.submit(run_bench, card, "--config", "stream", env=STREAM_BENCH_ENV)
        fleet = pool.submit(run_bench, card, "--config", "serve_fleet", env=FLEET_BENCH_ENV)
        line, fleet = stream.result(), fleet.result()
    check(line["accounted"] is True and line["cold_dispatches"] == 0, f"bench stream: {line}")
    check(fleet["accounted"] is True and fleet["byte_identical"] is True and fleet["recovered"] is True,
          f"bench serve_fleet: {fleet}")
    return launches

def multi_requests(torch, card, tag, engines, frames, want_launches, bound, ref_float=None) -> dict:
    """Phase 15's requests: each ``engines`` entry (name -> engine) answers
    ``frames`` once with its launches counted from 0 (``want_launches`` of
    each CLAHE kernel), then 3 timed calls (p50 ms). Answers are held to
    ``bound(name, uint8, float)`` against the first engine's. Returns the
    launches of the counted calls."""
    from waternet_tpu_torch.ops import kernels
    from waternet_tpu_torch.utils.tensor import ten2arr

    launches, base = {}, None
    for name, engine in engines.items():
        engine.enhance(frames)  # warm-up: cuDNN's plans for this shape
        torch.cuda.synchronize()
        kernels.reset_launches()
        out_f = engine.enhance_async(frames)
        out = ten2arr(out_f)
        grew = dict(kernels.LAUNCHES)
        want = {k: want_launches[name] * int(k in ("tile_lut", "clahe_lut_planes")) for k in grew}
        check(grew == want, f"M {tag} {name}: launches {grew}, want {want}")
        launches[name] = grew
        sec, _ = timed_p50(torch, lambda: engine.enhance(frames), 3)
        line = {"run": f"M {tag}", "engine": name, "shape": list(frames.shape), "ms_p50": sec * 1e3,
                "launches": grew, "card": card}
        if base is None:
            base = (out, out_f)
        else:
            d = np.abs(out.astype(np.int16) - base[0].astype(np.int16))
            line["vs_first"] = {"max_abs_diff": int(d.max()), "share_over_1": float((d > 1).mean()),
                                "float_max_abs_diff": (out_f - base[1]).abs().max().item()}
            bound(name, d, line["vs_first"]["float_max_abs_diff"])
        print(json.dumps(line), flush=True)
    return {f"multi_{tag}_{k}": v for k, v in launches.items() if k != next(iter(engines))}


def run_multi(torch, dev, card, t1_dir: Path) -> dict:
    """Phase 15 (M): multi-GPU on one card. Returns the launches of the
    sharded requests and of the DDP ranks, each counted from 0."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from waternet_tpu_torch.bench import _serving_population
    from waternet_tpu_torch.inference_engine import InferenceEngine
    from waternet_tpu_torch.ops import kernels
    from waternet_tpu_torch.parallel import distributed as pdist
    from waternet_tpu_torch.serving import RECEPTIVE_RADIUS, DynamicBatcher, derive_buckets
    from waternet_tpu_torch.utils.synthetic import photo_frames

    rng = np.random.default_rng(SEED + 15)
    r1 = photo_frames(rng, *REQUESTS["R1"])
    launches = {}

    # (a) Spatial sharding at R1, n shards sharing the card, fp32 and bf16.
    def one_level(name, d, fdiff):
        check(d.max() <= 1 and fdiff <= FAST_ATOL, f"M spatial {name}: {d.max()} levels, float {fdiff}")

    def bf16_levels(name, d, fdiff):
        check(d.max() <= BF16_LEVELS and (d > 1).mean() <= 0.01, f"M spatial {name}: {d.max()} levels")

    for dtype, bound_fn in ((torch.float32, one_level), (torch.bfloat16, bf16_levels)):
        tag = "spatial_R1_" + ("fp32" if dtype == torch.float32 else "bf16")
        engines = {"unsharded": InferenceEngine(weights=WEIGHTS, device_preprocess=True, device=dev, dtype=dtype)}
        for n in MULTI["spatial"]:
            engines[f"spatial{n}"] = InferenceEngine(weights=WEIGHTS, device_preprocess=True, dtype=dtype,
                                                     spatial_shards=n, devices=[dev] * n)
        launches.update(multi_requests(torch, card, tag, engines, r1,
                                       dict.fromkeys(engines, 1), bound_fn))
        del engines
        torch.cuda.empty_cache()

    # (b) Data sharding, 2 shards on the card, an odd batch (one padded frame).
    batch = r1[:MULTI["data_batch"]]
    ds = MULTI["data_shards"]
    engines = {"unsharded": InferenceEngine(weights=WEIGHTS, device_preprocess=True, device=dev),
               f"data{ds}": InferenceEngine(weights=WEIGHTS, device_preprocess=True, data_shards=ds,
                                            devices=[dev] * ds)}
    launches.update(multi_requests(torch, card, "data_R1_fp32", engines, batch, {"unsharded": 1, f"data{ds}": ds},
                                   lambda name, d, fdiff: check(d.max() <= 1, f"M data: {d.max()} levels")))
    del engines
    torch.cuda.empty_cache()

    # (c) A spatial-2 engine behind the batcher on S's population (fp32,
    # device preprocessing): the interior (farther than the receptive
    # radius from the pad seam, which is the native edge in both ladders)
    # within one level of the unsharded engine's bucketed answers.
    images, shapes = _serving_population(SERVE["n"], SERVE["base"])
    ladder = derive_buckets(shapes, max_buckets=SERVE["max_buckets"])
    answers = {}
    for name, kw in (("unsharded", {"device": dev}), ("spatial2", {"spatial_shards": 2, "devices": [dev] * 2})):
        engine = InferenceEngine(weights=WEIGHTS, device_preprocess=True, **kw)
        batcher = DynamicBatcher(engine, ladder, max_batch=SERVE["max_batch"])
        try:
            kernels.reset_launches()
            t0 = time.perf_counter()
            answers[name] = batcher.map_ordered(images)
            dt = time.perf_counter() - t0
            launches[f"multi_batcher_{name}"] = dict(kernels.LAUNCHES)
            summary = batcher.stats.summary()
        finally:
            batcher.close()
        print(json.dumps({"run": "M batcher", "engine": name, "images_per_s": len(images) / dt,
                          "buckets": batcher.ladder.describe(), "compiles": summary["compiles"],
                          "cold_dispatches": engine.cold_dispatches, "launches": launches[f"multi_batcher_{name}"],
                          "card": card}), flush=True)
        check(engine.cold_dispatches == 0, f"M batcher {name}: {engine.cold_dispatches} cold dispatches")
        del engine, batcher
        torch.cuda.empty_cache()
    r = RECEPTIVE_RADIUS
    worst = max(int(np.abs(a[: im.shape[0] - r, : im.shape[1] - r].astype(np.int16)
                           - b[: im.shape[0] - r, : im.shape[1] - r].astype(np.int16)).max())
                for a, b, im in zip(answers["spatial2"], answers["unsharded"], images))
    print(json.dumps({"run": "M batcher, spatial2 vs unsharded interior", "max_abs_diff": worst,
                      "images": len(images), "card": card}), flush=True)
    check(all(a.shape == im.shape for a, im in zip(answers["spatial2"], images)), "M batcher: shapes")
    check(worst <= 1, f"M batcher: spatial2 interior {worst} levels from unsharded")

    # (d) NCCL at world size 1 on the card: init, all_reduce, barrier, destroy.
    t0 = time.perf_counter()
    port = free_port()
    pdist.initialize(f"127.0.0.1:{port}", 1, 0, connect_timeout_sec=60, device=dev)
    backend = torch.distributed.get_backend()
    ones = torch.ones(4, device=dev)
    torch.distributed.all_reduce(ones)
    torch.distributed.barrier()
    total = ones.sum().item()
    pdist.shutdown()
    print(json.dumps({"run": "M nccl world 1", "backend": backend, "all_reduce_sum": total,
                      "seconds": time.perf_counter() - t0, "card": card}), flush=True)
    check(backend == "nccl" and total == 4.0 and not torch.distributed.is_initialized(),
          f"M nccl: backend {backend}, sum {total}")

    # (e) Two DDP ranks on the card through the supervisor (gloo over CUDA
    # tensors: NCCL refuses two ranks on one GPU), T1's fp32 config, beside
    # the train_chaos bench (in process, at an 8 s hang threshold),
    # bench --config serve_multi and (f) (no time of the four is compared:
    # they share the card).
    def chaos_line():
        from waternet_tpu_torch.bench import bench_train_chaos

        t0 = time.perf_counter()
        line = bench_train_chaos(dev, hang_sec=MULTI["chaos_hang_sec"])
        print("bench " + json.dumps(dict(line, card=card)), flush=True)
        print(json.dumps({"run": "bench train_chaos, in process", "wall_s": time.perf_counter() - t0}), flush=True)
        return line

    # (f) No silent fallback: spatial shards need that many cards.
    def refusal(d: Path):
        import cv2

        src = d / "in"
        src.mkdir()
        cv2.imwrite(str(src / "a.png"), r1[0][:64, :64, ::-1])
        return subprocess.run([sys.executable, "-m", "waternet_tpu_torch.inference", "--source", str(src),
                               "--weights", WEIGHTS, "--spatial-shards", "2", "--device", dev.type,
                               "--output-root", str(d / "out")],
                              cwd=REPO, capture_output=True, text=True, timeout=300)

    with tempfile.TemporaryDirectory() as d, ThreadPoolExecutor(4) as pool:
        root, hb_dir = Path(d) / "runs", Path(d) / "hb"
        cmd = [sys.executable, "-m", "waternet_tpu_torch.resilience.supervisor",
               "--workers", str(MULTI["ddp_workers"]), "--cpu-gloo", "--max-restarts", "0",
               "--heartbeat-dir", str(hb_dir), "--", "--device", dev.type, "--seed", str(SEED),
               "--train-root", str(root), *t1_args("fp32")]
        t0 = time.perf_counter()
        ddp = pool.submit(subprocess.run, cmd, cwd=REPO, capture_output=True, text=True, timeout=600,
                          env={k: v for k, v in os.environ.items() if k != "WATERNET_FAULTS"})
        chaos = pool.submit(chaos_line)
        multi = pool.submit(run_bench, card, "--config", "serve_multi", env=SERVE_MULTI_BENCH_ENV)
        refused = pool.submit(refusal, Path(d))
        proc = ddp.result()
        ddp_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"M DDP supervisor exited {proc.returncode}:\n{proc.stdout[-4000:]}\n"
              f"{proc.stderr[-4000:]}")
        csvs = {name: (np.loadtxt(root / "0" / name, delimiter=",", skiprows=1, ndmin=2),
                       np.loadtxt(t1_dir / name, delimiter=",", skiprows=1, ndmin=2))
                for name in ("metrics-train.csv", "metrics-val.csv")}
        config = json.loads((root / "0" / "config.json").read_text())
        report = json.loads((hb_dir / "supervisor-report.json").read_text())
        line, multi_line, refused = chaos.result(), multi.result(), refused.result()
    stats = records(proc.stdout, "epoch_stats")
    finals = {rec["process"]: rec["params_sha256"] for rec in records(proc.stdout, "final_state")}
    # Records that another rank's unterminated line pushed off a line start.
    displaced = len(stats) - sum(ln.startswith("epoch_stats {") for ln in proc.stdout.splitlines())
    totals = {}
    for s in stats:
        t1_launches(f"M DDP rank {s['process']}", s, totals)
    rel = {name: float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-12)))
           for name, (got, want) in csvs.items()}
    print(json.dumps({"run": "M DDP, 2 ranks on one card, T1 fp32", "supervisor_s": ddp_s,
                      "result": report["result"], "restarts": report["restarts"],
                      "num_processes": config["num_processes"], "params_sha256": finals,
                      "epoch_records_off_line_start": displaced,
                      "max_rel_vs_one_process_T1": rel, "epoch_stats": stats, "launches": totals,
                      "card": card}), flush=True)
    check(report["result"] == "completed" and config["num_processes"] == MULTI["ddp_workers"],
          f"M DDP: {report['result']}, {config['num_processes']} processes")
    check(len(stats) == MULTI["ddp_workers"] * T1["epochs"], f"M DDP: {len(stats)} epoch lines")
    check(len(finals) == MULTI["ddp_workers"] and len(set(finals.values())) == 1,
          f"M DDP: the ranks' final parameters differ: {finals}")
    check(all(r <= MULTI["ddp_rel"] for r in rel.values()), f"M DDP: CSVs rel {rel} from phase 7's T1 fp32")
    launches["multi_ddp_ranks"] = totals
    print(json.dumps({"run": "M bench train_chaos", "recovered": line["recovered"], "restarts": line["restarts"],
                      "exact_resume": line["exact_resume"], "recovery_sec": line["recovery_sec"],
                      "steps_lost": line["steps_lost"], "card": card}), flush=True)
    check(line["metric"] == BENCH_METRIC[("--config", "train_chaos")] and math.isfinite(line["value"])
          and line["value"] > 0, f"M train_chaos: {line}")
    check(line["recovered"] and line["restarts"] == 2 and line["generations"] == 3,
          f"M train_chaos: {line}")
    n_cards = torch.cuda.device_count()
    check(multi_line["replica_invariant"] is True and multi_line["replicas"] == n_cards
          and ("note" in multi_line) == (n_cards == 1), f"M serve_multi: {multi_line}")
    print(json.dumps({"run": "M inference --spatial-shards 2", "cards": n_cards, "returncode": refused.returncode,
                      "stderr_tail": refused.stderr.strip().splitlines()[-1:], "card": card}), flush=True)
    if n_cards < 2:
        check(refused.returncode != 0 and f"only {n_cards} are available" in refused.stderr,
              f"M: --spatial-shards 2 on {n_cards} card(s) exited {refused.returncode}: {refused.stderr[-500:]}")
    else:
        check(refused.returncode == 0, f"M: --spatial-shards 2 on {n_cards} cards failed: {refused.stderr[-500:]}")
    return launches


def _first_port_frame(stack) -> str:
    """``path:line`` (relative to the repository) of the innermost frame
    of ``stack`` inside ``waternet_tpu_torch``, or "" when none is."""
    pkg = str(REPO / "waternet_tpu_torch")
    for frame in reversed(stack):
        if frame.filename.startswith(pkg):
            return f"{Path(frame.filename).relative_to(REPO)}:{frame.lineno}"
    return ""


class SyncWatch:
    """``torch.cuda.set_sync_debug_mode("warn")`` over a block, with every
    "synchronizing CUDA operation" warning recorded with the tag current
    when it fired and its first ``waternet_tpu_torch`` frame. The mode is
    reset to 0 on the way out, whatever happens in the block."""

    def __init__(self, torch):
        self.torch = torch
        self.tag = None
        self.records = []  # (tag, site)

    def _hook(self, message, category, filename, lineno, file=None, line=None):
        import traceback

        if "synchronizing CUDA operation" in str(message):
            self.records.append((self.tag, _first_port_frame(traceback.extract_stack()[:-1])))

    def __enter__(self):
        import warnings

        self._ctx = warnings.catch_warnings()
        self._ctx.__enter__()
        warnings.simplefilter("always")
        warnings.showwarning = self._hook
        self.torch.cuda.synchronize()
        self.torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        try:
            self.torch.cuda.set_sync_debug_mode(0)
        finally:
            self._ctx.__exit__(*exc)


def run_watchdogs(torch, dev, card) -> dict:
    """Phase 16 (X): the static analyzer's runtime companions on the card.
    Returns the launches of (a)'s serving run and of (b)'s train runs.

    (a) The lock watchdog (``waternet_tpu_torch.analysis.locktrace``, the
    runtime side of R102): a ``LockTracer`` installed before anything is
    built; a bf16 ``ServingServer`` with device preprocessing (its
    bucketed ``DynamicBatcher``, one replica on the card, the HTTP front
    door) on phase 12's ladder answers 12 of its population and one
    6-frame stream session; the traced lock sites and edges are printed
    and the graph must be acyclic.

    (b) The sync watch, the runtime side of R003: six steps of T2's config
    (16 x 112x112, raw cache, bf16) through ``_drive_train_epoch``, once
    without a sentinel and once under a ``DivergenceSentinel`` at a window
    of 2, under ``torch.cuda.set_sync_debug_mode("warn")`` (reset to 0 on
    the way out, even on failure). Every synchronizing operation is
    printed per step with its first ``waternet_tpu_torch`` frame; each of
    those sites must be one the static R003 reports (``lint_models`` over
    the port and this script, suppressed findings included).

    What ``set_sync_debug_mode`` does not see, checked again on each run
    (each operation of R003's list alone, printed): ``torch.cuda.
    synchronize()`` and ``torch.cuda.Event.synchronize()``, explicit waits
    that raise no warning, and ``torch.equal()``, whose host-side bool
    raises none either, so R003 names them from the source alone.
    ``Stream.synchronize()``, ``.item()``, ``.cpu()``, ``float()``, an
    output-size readback (``nonzero``, mask indexing) and a copy from
    pageable host memory are reported; a pinned ``non_blocking`` copy is
    no sync. Work the host waits for outside torch (cv2, a ``Future``) is
    not a CUDA sync and is R103/R201's business."""
    from waternet_tpu_torch.analysis import lint_models, parse_model
    from waternet_tpu_torch.analysis.core import collect_py_files
    from waternet_tpu_torch.analysis.lint_all import DEFAULT_TARGETS
    from waternet_tpu_torch.analysis.locktrace import LockTracer

    launches, out = {}, {}
    # (a) The lock watchdog around a serving run.
    tracer = LockTracer()
    tracer.install()
    try:
        from waternet_tpu_torch.bench import _serving_population
        from waternet_tpu_torch.inference_engine import InferenceEngine
        from waternet_tpu_torch.ops import kernels
        from waternet_tpu_torch.serving import derive_buckets
        from waternet_tpu_torch.serving.loadgen import run_load
        from waternet_tpu_torch.serving.server import ServingServer

        images, shapes = _serving_population(SERVE["n"], SERVE["base"])
        ladder = derive_buckets(shapes, max_buckets=SERVE["max_buckets"])
        engine = InferenceEngine(weights=WEIGHTS, device_preprocess=True, device=dev, dtype=torch.bfloat16)
        server = ServingServer(engine, ladder, max_batch=SERVE["max_batch"], max_wait_ms=5.0, replicas=1,
                               max_queue=256)
        pngs = [_png(im) for im in images[: WATCH["requests"]]]
        server.start_background(timeout=60)
        try:
            server.wait_ready(timeout=300)
            kernels.reset_launches()
            rep = run_load(server.url, pngs, concurrency=SERVE["concurrency"], total=len(pngs))
            status, _, recs = stream_session(server.bound_port, pngs[: WATCH["stream_frames"]],
                                             {"X-Stream-Budget-Ms": "60000"})
            torch.cuda.synchronize()
            launches["watch_X_serving"] = dict(kernels.LAUNCHES)
        finally:
            server.request_drain()
            code = server.join(timeout=300)
    finally:
        tracer.uninstall()
    check(code == 0, f"X(a): the server's drain exited {code}")
    check(rep["ok"] == len(pngs) and rep["errors"] == 0, f"X(a): load report {rep}")
    kinds = [r[0] for r in recs]
    check(status == 200 and kinds == [b"F"] * WATCH["stream_frames"] + [b"Z"], f"X(a): stream records {kinds}")
    check(launches["watch_X_serving"] == NO_LAUNCH, f"X(a): launches {launches['watch_X_serving']}")

    def rel(site):
        path, _, line = site.rpartition(":")
        p = Path(path)
        return f"{p.relative_to(REPO) if p.is_relative_to(REPO) else p.name}:{line}"

    edges = sorted(f"{rel(a)} -> {rel(b)}" for a, b in tracer.edges)
    out["a"] = {"requests": len(pngs), "stream_frames": WATCH["stream_frames"],
                "lock_sites": [rel(s) for s in tracer.sites], "edges": edges,
                "cycle": tracer.cycle()}
    print(json.dumps({"run": "X(a) lock watchdog", **out["a"], "card": card}), flush=True)
    tracer.assert_acyclic()
    del server, engine

    # (b) The sync watch over T2's bf16 steps.
    from waternet_tpu_torch.data.synthetic import SyntheticPairs
    from waternet_tpu_torch.resilience import DivergenceSentinel, EpochControl
    from waternet_tpu_torch.training.trainer import TrainConfig, TrainingEngine, step_generator

    # Which operations the debug mode reports, each alone (R003's list).
    x = torch.arange(-4.0, 4.0, device=dev)
    host = torch.ones(8)
    ev = torch.cuda.Event()
    ops = {
        "torch.cuda.synchronize()": torch.cuda.synchronize,
        "Event.synchronize()": ev.synchronize,
        "Stream.synchronize()": lambda: torch.cuda.current_stream().synchronize(),
        ".item()": lambda: x.sum().item(),
        ".cpu()": x.cpu,
        "float()": lambda: float(x.sum()),
        "nonzero()": x.nonzero,
        "mask indexing": lambda: x[x > 0],
        "torch.equal()": lambda: torch.equal(x, x),
        "pageable .to(device)": lambda: host.to(dev),
        "torch.tensor(device=)": lambda: torch.tensor([1.0, 2.0], device=dev),
        "pinned non_blocking .to(device)": lambda: host.pin_memory().to(dev, non_blocking=True),
    }
    seen = {}
    for name, fn in ops.items():
        ev.record()
        with SyncWatch(torch) as w:
            fn()
        seen[name] = bool(w.records)
    print(json.dumps({"run": "X(b) what set_sync_debug_mode reports", "reported": seen, "card": card}), flush=True)
    check(seen[".item()"] and seen["Stream.synchronize()"] and not seen["pinned non_blocking .to(device)"],
          f"X(b): the debug mode reports {seen}")

    n_steps = WATCH["steps"]
    cfg = TrainConfig(batch_size=T2["batch"], im_height=T2["hw"], im_width=T2["hw"], precision="bf16",
                      cache_codec="raw", precache_histeq=False, seed=SEED)
    ds = SyntheticPairs(n_steps * T2["batch"], T2["hw"], T2["hw"], seed=SEED)
    engine = TrainingEngine(cfg, device=dev)
    engine.cache_dataset(ds, np.arange(len(ds)))
    step_fn, cache_args = engine.cached_train_step()
    runs = {}
    for run, control in (("no_sentinel", None),
                         ("sentinel_window_2", EpochControl(sentinel=DivergenceSentinel(window=WATCH["window"])))):
        with SyncWatch(torch) as watch:

            def payloads():
                batches = engine._cached_index_batches(engine._cache_len, 0, True, 0)
                for count, (idx, n_real) in enumerate(batches):
                    yield count, {"idx": idx, "n_real": n_real}
                watch.tag = "epoch_end"  # the dispatch loop asked for more: it is over

            def dispatch(count, payload):
                watch.tag = f"step_{count + 1}"
                m = engine._post_step(step_fn(*cache_args, payload["idx"], step_generator(SEED, 0, count),
                                               payload["n_real"]))
                watch.tag = f"after_step_{count + 1}"
                return m

            kernels.reset_launches()
            watch.tag = "epoch_start"
            means = engine._drive_train_epoch(payloads(), dispatch, control)
            torch.cuda.synchronize()
            launches[f"watch_X_train_{run}"] = dict(kernels.LAUNCHES)
        check(all(math.isfinite(v) for v in means.values()), f"X(b) {run}: {means}")
        want = dict(NO_LAUNCH, tile_lut=n_steps, clahe_lut_planes=n_steps)
        check(launches[f"watch_X_train_{run}"] == want, f"X(b) {run}: launches {launches[f'watch_X_train_{run}']}")
        # Each step's syncs (its window fetch included), by site.
        per_step = {f"step_{k}": {} for k in range(1, n_steps + 1)}
        for tag, site in watch.records:
            counts = per_step.setdefault(tag.replace("after_", ""), {})
            counts[site] = counts.get(site, 0) + 1
        warm = sum(sum(per_step[f"step_{k}"].values()) for k in range(2, n_steps + 1))
        runs[run] = {"syncs_by_step": per_step, "syncs_per_warm_step": warm / (n_steps - 1),
                     "sites": sorted({site for _, site in watch.records})}
    static = set()
    models = [parse_model(f) for f in collect_py_files([REPO / t for t in DEFAULT_TARGETS])]
    for f in lint_models(models, ["R003"]):
        static.add(f"{Path(f.path).resolve().relative_to(REPO)}:{f.line}")
    missed = sorted({s for r in runs.values() for s in r["sites"]} - static)
    out["b"] = {"steps": n_steps, "batch": T2["batch"], "hw": T2["hw"], "precision": "bf16",
                "runs": runs, "static_r003_sites": len(static), "missed_by_r003": missed}
    print(json.dumps({"run": "X(b) sync watch", **out["b"], "card": card}), flush=True)
    check(not missed, f"X(b): synchronizing sites the static R003 does not report: {missed}")
    check(all(s for r in runs.values() for s in r["sites"]), "X(b): a sync outside waternet_tpu_torch")
    del engine
    torch.cuda.empty_cache()
    return launches


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is False", file=sys.stderr)
        return 2

    from waternet_tpu_torch.inference_engine import InferenceEngine
    from waternet_tpu_torch.ops import _build, kernels
    from waternet_tpu_torch.ops.clahe import clahe, clahe_inputs
    from waternet_tpu_torch.utils.device import gpu_card_line, resolve_device
    from waternet_tpu_torch.utils.synthetic import photo_frames

    rng = np.random.default_rng(SEED)

    # Each phase's wall seconds, printed before the summary.
    phase_s, t_phase = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        phase_s[name] = now - t_phase[0]
        t_phase[0] = now

    # 1. Card and numerics.
    dev = resolve_device("cuda")
    card = gpu_card_line()
    print(f"card: {card}", flush=True)
    tf32 = {
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
        "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
    }
    print(f"tf32: {json.dumps(tf32)}", flush=True)
    check(not any(tf32.values()), f"TF32 must be off: {tf32}")

    # 2. Build.
    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s ({_build.ARCH}, "
          f"{len(_build.SOURCES)} sources)", flush=True)
    ptxas = (_build.BUILD_DIR / (_build.LIB_NAME + ".log"))
    if ptxas.is_file():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"ptxas: {line.strip()}", flush=True)

    lap("1-2 card, build")

    # 3. The CLAHE kernels against their plain versions, on the card.
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # What this timing reads for the smallest kernel: one fill of 4 bytes.
    one = torch.empty(1, dtype=torch.int32, device=dev)
    print(json.dumps({"launch_floor_ms": device_ms(torch, one.zero_, flush), "card": card}),
          flush=True)
    ty, tx = 8, 8
    summary = {}
    planes = l_planes(torch, dev, rng)
    for tag, lum in planes.items():
        n, h, w = lum.shape
        l_pad, clip, scale, g = clahe_inputs(lum, tile_grid=(ty, tx))
        hp, wp = l_pad.shape[1:]
        th, tw = g["tile"]
        idx = (*g["y"], *g["x"])

        luts_k = kernels.tile_lut(l_pad, (ty, tx), clip, scale)
        luts_p = kernels.tile_lut_plain(l_pad, (ty, tx), clip, scale)
        wts = (g["ya"], g["xa"], h, w)
        planes_k = kernels.clahe_lut_planes(luts_p, l_pad, *idx)
        planes_p = kernels.clahe_lut_planes_plain(luts_p, l_pad, *idx)
        blend_k = kernels.clahe_lut_blend(luts_p, l_pad, *idx, *wts)
        blend_p = kernels.clahe_lut_blend_plain(luts_p, l_pad, *idx, *wts)

        def parent_path():  # the parent's: the f32 planes kernel, then the eager blend
            return kernels.blend_quadrants(*kernels.clahe_lut_planes(luts_p, l_pad, *idx)[..., :h, :w],
                                           g["ya"], g["xa"])

        blend_parent = parent_path()
        # jaxlint: disable-next=R003 smoke check: reads the result back to compare or time it
        torch.cuda.synchronize()
        # jaxlint: disable-next=R003 smoke check: reads the result back to compare or time it
        err_lut = (luts_k - luts_p).abs().max().item()
        # jaxlint: disable-next=R003 smoke check: reads the result back to compare or time it
        err_planes = (planes_k - planes_p).abs().max().item()
        # jaxlint: disable-next=R003 smoke check: reads the result back to compare or time it
        err_blend = (blend_k - blend_p).abs().max().item()
        # jaxlint: disable-next=R003 smoke check: reads the result back to compare or time it
        check(torch.equal(luts_k, luts_p), f"tile_lut != plain at {tag} {n}x{h}x{w}")
        check(
            # jaxlint: disable-next=R003 smoke check: reads the result back to compare or time it
            torch.equal(planes_k, planes_p),
            f"clahe_lut_planes != plain at {tag} {n}x{h}x{w}",
        )
        check(blend_k.shape == (n, h, w), f"clahe_lut_blend shape {tuple(blend_k.shape)}")
        # jaxlint: disable-next=R003 smoke check: reads the result back to compare or time it
        check(torch.equal(blend_k, blend_p), f"clahe_lut_blend != plain at {tag} {n}x{h}x{w}")
        # jaxlint: disable-next=R003 smoke check: reads the result back to compare or time it
        check(torch.equal(blend_k, blend_parent),
              f"clahe_lut_blend != the planes kernel + eager blend at {tag}")

        # Yardstick: the four quadrant gathers as one PyTorch indexing call.
        img = torch.arange(n, device=dev)[None, :, None, None]
        yq = torch.stack([idx[0], idx[0], idx[1], idx[1]]).long()[:, None, :, None]
        xq = torch.stack([idx[2], idx[3], idx[2], idx[3]]).long()[:, None, None, :]
        v = l_pad.long()[None]
        check(torch.equal(luts_p[img, yq, xq, v], planes_p), "yardstick gather differs")

        def library_blend():  # yardstick: the one-call gather, then the same eager blend
            return kernels.blend_quadrants(*luts_p[img, yq, xq, v][..., :h, :w], g["ya"], g["xa"])

        lut_bytes = n * ty * tx * 256 * 4
        idx_bytes = 2 * (hp + wp) * 4
        # Yardstick: one bincount of precomputed tile-keyed levels (every
        # tile's histogram; the clip and scan are left out), keys untimed.
        keys = tile_keys(torch, l_pad, ty, tx)
        n_bins = n * ty * tx * 256
        rows = {
            "tile_lut": {
                "ms": device_ms(torch, lambda: kernels.tile_lut(l_pad, (ty, tx), clip, scale), flush),
                "plain_ms": device_ms(
                    torch, lambda: kernels.tile_lut_plain(l_pad, (ty, tx), clip, scale), flush
                ),
                "library_ms": device_ms(torch, lambda: torch.bincount(keys, minlength=n_bins), flush),
                "bytes": n * hp * wp + lut_bytes,
                "max_abs_err": err_lut,
            },
            "clahe_lut_planes": {
                "ms": device_ms(torch, lambda: kernels.clahe_lut_planes(luts_p, l_pad, *idx), flush),
                "plain_ms": device_ms(
                    torch, lambda: kernels.clahe_lut_planes_plain(luts_p, l_pad, *idx), flush
                ),
                "library_ms": device_ms(torch, lambda: luts_p[img, yq, xq, v], flush),
                "bytes": lut_bytes + n * hp * wp + idx_bytes + 4 * n * hp * wp * 4,
                "max_abs_err": err_planes,
            },
            # Reads the kept pixels only; 14 float32 ops a kept pixel.
            "clahe_lut_blend": {
                "ms": device_ms(torch, lambda: kernels.clahe_lut_blend(luts_p, l_pad, *idx, *wts), flush),
                "plain_ms": device_ms(
                    torch, lambda: kernels.clahe_lut_blend_plain(luts_p, l_pad, *idx, *wts), flush
                ),
                "parent_path_ms": device_ms(torch, parent_path, flush),
                "library_ms": device_ms(torch, library_blend, flush),
                "bytes": lut_bytes + n * h * w + idx_bytes + (h + w) * 4 + n * h * w * 4,
                "flops": 14 * n * h * w,
                "max_abs_err": err_blend,
            },
        }
        plans = {"tile_lut": kernels.tile_plan(n, hp, wp, ty, tx, l_pad.data_ptr(), sms)._asdict()}
        for name, rows_, cols_, out in (("clahe_lut_planes", hp, wp, planes_k),
                                        ("clahe_lut_blend", h, w, blend_k)):
            plan = kernels.lut_blend_plan(n, rows_, cols_, wp, tx, g["y"][0].cpu().numpy(),
                                          g["y"][1].cpu().numpy(), l_pad.data_ptr(),
                                          out.data_ptr(), sms)
            plans[name] = {"strips": plan.grid[0], "ctas": plan.grid[0] * n,
                           "rows_per_strip": [int(np.diff(plan.strips).min()),
                                              int(np.diff(plan.strips).max())],
                           "vec": plan.vec, "threads": plan.threads, "smem_bytes": plan.smem}
        if tag == "main":
            # What the shared-memory gathers' bank conflicts cost: the blend
            # on the same shape when every lane reads one address (a constant
            # plane: broadcasts), on the photo planes, and on uniform random
            # levels (the most conflicts).
            probe = {"photo": rows["clahe_lut_blend"]["ms"]}
            gen = torch.Generator(dev).manual_seed(SEED)
            uniform = torch.randint(0, 256, l_pad.shape, device=dev, dtype=torch.uint8, generator=gen)
            for kind, plane in (("constant", torch.full_like(l_pad, 128)),
                                ("uniform_random", uniform)):
                probe[kind] = device_ms(
                    torch, lambda: kernels.clahe_lut_blend(luts_p, plane, *idx, *wts), flush)
            print(json.dumps({"kernel": "clahe_lut_blend", "shape": tag,
                              "ms_by_plane_content": probe, "card": card}), flush=True)
        if tag in ("main", "odd"):
            # tile_lut under each cluster size: the same bits, and the times
            # the plan's choice of K rests on.
            vec = plans["tile_lut"]["vec"]
            sweep = {}
            for k in (1, 2, 4, 8):
                plan = kernels.TilePlan(k, vec, 256, n * ty * tx * k)
                # jaxlint: disable-next=R003 smoke check: reads the result back to compare or time it
                check(torch.equal(kernels.tile_lut(l_pad, (ty, tx), clip, scale, plan=plan), luts_p),
                      f"tile_lut at K={k} != plain at {tag}")
                sweep[k] = device_ms(
                    torch, lambda: kernels.tile_lut(l_pad, (ty, tx), clip, scale, plan=plan), flush
                )
            print(json.dumps({"kernel": "tile_lut", "shape": tag, "vec": vec,
                              "ms_by_cluster_size": sweep, "card": card}), flush=True)
        for name, r in rows.items():
            r["bound_ms"], r["bound_by"] = bound(r["bytes"], r.get("flops", 0))
            extra = {"parent_path_ms": r["parent_path_ms"], "equals_parent_path": True} \
                if "parent_path_ms" in r else {}
            kernel_line(name, tag, {"n": n, "h": h, "w": w, "padded": [hp, wp], "tile": [th, tw]},
                        r, card, plan=plans[name], **extra)
        if tag == "main":
            # The main path's launch of clahe_lut_planes is the fused blend.
            summary["tile_lut"] = rows["tile_lut"]
            summary["clahe_lut_planes"] = dict(rows["clahe_lut_blend"],
                                               f32_planes_kernel=rows["clahe_lut_planes"])
        del luts_k, planes_k, planes_p, blend_k, blend_p, blend_parent

        # 4. CLAHE through the kernels == the plain CLAHE.
        got = clahe(lum, use_kernels=True)
        want = clahe(lum, use_kernels=False)
        check(torch.equal(got, want), f"clahe(kernels) != clahe(plain) at {tag}")
        print(f"clahe {tag} {n}x{h}x{w}: kernels == plain, bit for bit", flush=True)

    lap("3-4 CLAHE kernels")

    # 5. The inference path answers requests.
    engine = InferenceEngine(weights=WEIGHTS, device_preprocess=True)
    batches = {k: photo_frames(rng, *shape) for k, shape in REQUESTS.items()}
    for b in batches.values():  # warm-up: one call per request shape
        engine.enhance(b)
    torch.cuda.synchronize()

    clahe_kernels = ("tile_lut", "clahe_lut_planes")
    kernels.reset_launches()
    outs = {}
    for name, batch in batches.items():
        before = dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = engine.enhance(batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        grew = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        want = {k: int(k in clahe_kernels) for k in grew}
        check(grew == want, f"{name}: launches {grew}, want {want}")
        check(out.dtype == np.uint8 and out.shape == batch.shape, f"{name}: output {out.dtype} {out.shape}")
        outs[name] = out
        print(json.dumps({
            "request": name, "shape": list(batch.shape), "latency_ms": dt * 1e3,
            "frames_per_s": len(batch) / dt, "launches": grew, "card": card,
        }), flush=True)
    launches = {"inference": dict(kernels.LAUNCHES)}
    check(all(launches["inference"][k] == len(REQUESTS) for k in clahe_kernels),
          f"inference path launches {launches['inference']}")

    # Steady-state R1 latency (outside the counted run).
    torch.cuda.reset_peak_memory_stats()
    lat = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.enhance(batches["R1"])
        lat.append(time.perf_counter() - t0)
    p50 = statistics.median(lat)
    r1_fp32 = {"latency_ms_p50": p50 * 1e3, "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    print(json.dumps({
        "request": "R1 x5", "latency_ms_p50": p50 * 1e3, "latency_ms": [t * 1e3 for t in lat],
        "frames_per_s": REQUESTS["R1"][0] / p50,
        "peak_mem_bytes": r1_fp32["peak_mem_bytes"], "card": card,
    }), flush=True)

    # R3 on the CPU port: within one uint8 level.
    cpu = InferenceEngine(weights=WEIGHTS, device_preprocess=True, device="cpu")
    ref = cpu.enhance(batches["R3"])
    diff = np.abs(ref.astype(np.int16) - outs["R3"].astype(np.int16))
    print(json.dumps({
        "R3_vs_cpu": {"max_abs_diff": int(diff.max()), "share_differing": float((diff > 0).mean())},
    }), flush=True)
    check(diff.max() <= 1, f"R3 differs from the CPU port by {diff.max()} levels")
    for name, out in outs.items():
        check(out.std() > 0, f"{name}: constant output")
    del engine, cpu
    torch.cuda.empty_cache()

    lap("5 inference")

    # 6. The training slice's kernels against their plain versions.
    summary.update(new_kernels_phase(torch, dev, flush, card, planes))
    del flush, planes
    torch.cuda.empty_cache()

    lap("6 training kernels")

    # 7. Training on the card: each run's launches are counted from 0.
    t1_dir = Path(tempfile.mkdtemp(prefix="chip-smoke-t1-"))
    launches["train_T1_fp32"] = run_cli_training(torch, card, "fp32", keep=t1_dir)
    launches["train_T1_bf16"] = run_cli_training(torch, card, "bf16")
    launches["train_T2_fp32"] = run_t2(torch, dev, card)
    run_t3(torch, dev, card)

    lap("7 T1-T3")

    # 8. Host-fed training: T4 and its checks.
    launches["train_T4"] = run_t4(torch, dev, card)

    lap("8 T4")

    # 9. The precache tables (the --device-cache default) and the bench.
    launches["train_T5"] = run_t5(card)
    run_t5_exact(torch, dev, card)
    lap("9 T5a-b")
    run_bench(card)
    run_bench(card, "--config", "train_fullres")
    lap("9 T5c bench")

    # 10. V: video through the stream and the CLI, bf16 R1, the video bench.
    launches["video"] = run_video(torch, dev, card, r1_fp32)
    lap("10 V video")

    # 11. R: resume and resilience on the card; R4's CLI processes run
    # beside R1-R3 (bit for bit on the engine: their bits do not depend on
    # what else runs, and each process counts its own launches).
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as pool:
        r4 = pool.submit(run_resume_cli, torch, card)
        launches["resume_R1"] = run_resume_engine(torch, dev, card, "R1")
        launches["resume_R2"] = run_resume_engine(torch, dev, card, "R2")
        launches["resume_R3"] = run_resume_nan(torch, dev, card)
        launches["resume_R4"] = r4.result()
    lap("11 R resume")

    # 12. S: serving.
    launches.update(run_serving(torch, dev, card))
    lap("12 S serving")

    # 13. F: the fast tier.
    launches.update(run_fast_tier(torch, dev, card))
    lap("13 F fast tier")

    # 14. St: stream sessions, the fleet, the trace CLI.
    launches.update(run_streams_fleet(torch, dev, card))
    lap("14 St streams, fleet")

    # 15. M: multi-GPU on one card.
    launches.update(run_multi(torch, dev, card, t1_dir))
    shutil.rmtree(t1_dir, ignore_errors=True)
    lap("15 M multi-GPU")

    # 16. X: the analyzer's runtime companions (lock order, syncs a step).
    launches.update(run_watchdogs(torch, dev, card))
    lap("16 X watchdogs")
    print(json.dumps({"phase_s": phase_s, "total_s": sum(phase_s.values())}), flush=True)

    kernels_line = []
    for name in REPLACES:
        r = summary[name]
        by_path = {path: counts[name] for path, counts in launches.items()}
        kernels_line.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **({"parent_path_ms": r["parent_path_ms"]} if "parent_path_ms" in r else {}),
            **({"f32_planes_kernel": {k: r["f32_planes_kernel"][k] for k in
                                      ("ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")}}
               if "f32_planes_kernel" in r else {}),
        })
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(card, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
