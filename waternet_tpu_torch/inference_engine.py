"""Batched inference engine: uint8 frames in, enhanced uint8 frames out.

Two preprocessing modes, as in the JAX package's engine
(waternet_tpu/inference_engine.py:104-290):

* host (default): cv2/NumPy WB + GC + CLAHE per frame, bit-exact with the
  reference;
* device (``device_preprocess=True``): the batch's WB/GC/CLAHE run on the
  device (:func:`~waternet_tpu_torch.ops.transform.transform_batch`, with
  the CLAHE kernels on CUDA) right before the forward, so the host only
  ships raw uint8 frames.

``dtype=torch.bfloat16`` runs the model (and only the model: the
transforms stay in uint8/float32) under ``torch.autocast`` with fp32
parameters, as the JAX engine applies its ``dtype`` to the forward alone;
the result is float32 either way. Host batches go to CUDA through pinned
memory without waiting for the stream, so :meth:`enhance_async` returns
while the previous batch still runs.

The padded entry points (:meth:`pad_raw_to_bucket`,
:meth:`preprocess_padded`, :meth:`enhance_padded_async`,
:meth:`warm_padded`, :meth:`replica_params`) serve the shape-bucketed
path of ``waternet_tpu_torch/serving/`` (the JAX engine's
``inference_engine.py:55-420``). Eager PyTorch has no compiler to count:
what the first call at a new shape pays is cuDNN's execution plan and
the caching allocator's blocks. So the engine records each ``(path,
batch shape, device)`` key it has run (:meth:`shape_cache_size`), a
bucketed key is *warm* once :meth:`warm_padded` has handed out its
callable, and a bucketed dispatch of a key never warmed counts in
``cold_dispatches``: serving pins that count at zero, as the JAX package
pins its jit caches with ``compile_sentinel``. ``cudnn.benchmark`` stays
off: autotuning may pick another algorithm in another process.

``quantize=True`` converts the checkpoint to static int8 at construction
(:mod:`waternet_tpu_torch.models.quant`: exact int8 x int8 -> int32
convolutions through ``torch._int_mm``); the activation scales calibrate
on ``calib_batches`` or on synthetic frames, always on the host, so an
engine on the card holds the CPU port's qtree bit for bit (a calibration
forward on the card rounds other activations and moves the scales).

``spatial_shards`` and ``data_shards`` (the JAX engine's, mutually
exclusive) run the quality engine over a mesh of ``devices``
(:mod:`waternet_tpu_torch.parallel`): spatial sharding splits each image's
height with the exact halo scheme of ``parallel/spatial.py`` after
preprocessing the whole image once on the first device; data sharding
splits the frame batch, padded with its last frame to a multiple of the
shard count and cropped back, with a model replica and the preprocessing
on each shard's device. Both compose with ``quantize`` and ``dtype``.

:class:`StudentEngine` is the fast tier: the distilled CAN student
(``models/can.py``), raw uint8 frames in, enhanced uint8 frames out, with
no WB, GC or CLAHE anywhere. It implements the same serving interface
(``enhance``, ``enhance_async``, ``warm_padded``, ``enhance_padded(_async)``,
``replica_params``, ``set_params``, ``shape_cache_size``, ``_dev``), so
the batcher serves it as a second tier on the same ladder
(``DynamicBatcher(fast_engine=...)``); its native and padded paths are one
function, uint8 -> /255 -> student.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from waternet_tpu_torch.hub import build_model, check_dtype, resolve_weights, run_model
from waternet_tpu_torch.models import quant
from waternet_tpu_torch.ops.transform import transform_batch, transform_np
from waternet_tpu_torch.utils.device import resolve_device
from waternet_tpu_torch.utils.tensor import ten2arr, to_device


class _ServingEngineBase:
    """The serving-interface plumbing both tier engines share: the shape
    keys behind ``cold_dispatches``, device placement, the canvas padding,
    the sync wrappers and ``warm_padded``. A subclass sets ``device``,
    ``params`` and ``model`` and provides ``_build(params, device)``,
    ``enhance_async`` and ``enhance_padded_async``."""

    data_shards = 1
    spatial_shards = 1
    device_preprocess = False
    quantized = False

    def _init_keys(self) -> None:
        # Called from the constructor, before any thread can see the engine:
        # the first writes need no lock.
        self._keys_lock = threading.Lock()
        # jaxlint: disable-next=R101 constructor-time first write, before any thread exists
        self._seen: set = set()  # guarded-by: self._keys_lock
        # jaxlint: disable-next=R101 constructor-time first write, before any thread exists
        self._warm: set = set()  # guarded-by: self._keys_lock
        # jaxlint: disable-next=R101 constructor-time first write, before any thread exists
        self.cold_dispatches = 0  # guarded-by: self._keys_lock

    def enhance(self, rgb_batch) -> np.ndarray:
        """(N, H, W, 3) uint8 RGB -> (N, H, W, 3) uint8 RGB enhanced."""
        return ten2arr(self.enhance_async(rgb_batch))

    def _note_shape(self, key, padded: bool) -> None:
        """Record that ``key`` ran; a bucketed key that :meth:`warm_padded`
        never warmed, met for the first time, is a cold dispatch."""
        with self._keys_lock:
            if key in self._seen:
                return
            self._seen.add(key)
            if padded and key not in self._warm:
                self.cold_dispatches += 1

    def shape_cache_size(self) -> int:
        """How many ``(path, batch shape, device)`` keys the engine has run:
        the port's counterpart of the JAX engine's jit cache sizes (its
        growth across a call is the number of shapes first met there)."""
        with self._keys_lock:
            return len(self._seen)

    @property
    def sharded(self) -> bool:
        """Whether the engine's forward spans a mesh of devices."""
        return self.spatial_shards > 1 or self.data_shards > 1

    def _dev(self, device) -> torch.device:
        return self.device if device is None else torch.device(device)

    def replica_params(self, device):
        """The engine's weights on ``device``, as a model bound to them: one
        copy per serving replica (``serving/replicas.py``). ``None`` returns
        the engine's own model."""
        if device is None:
            return self.model
        return self._build(self.params, torch.device(device))

    def set_params(self, params: dict) -> None:
        """Swap in new weights (hot reload): a fresh model replaces the old
        one whole, so a call that already read ``self.model`` finishes on
        the old weights. Callers validate the shapes first. A quantized
        engine quantizes the new weights with its calibration batches."""
        if self.quantized:
            params = self._quantize(params)
        model = self._build(params, self.device)
        self.params, self.model = params, model

    def pad_raw_to_bucket(self, images, bucket_hw, n_slots=None):
        """Mixed-native-shape uint8 HWC images -> (uint8 canvas batch, (N, 2)
        int32 native shapes) at one ``bucket_hw`` canvas shape.

        Only the raw bytes are padded here (reflect, bottom/right); what
        happens to the canvas is the engine's business (the quality tier's
        device-preprocess program computes WB/GC/CLAHE statistics over each
        native region, ops/masked.py; the student needs none). Batch padding
        repeats the last image (the forward is per-sample independent, so it
        never changes a real sample's output, and the batch shape never
        changes)."""
        from waternet_tpu_torch.serving.bucketing import pad_to_bucket

        if not images:
            raise ValueError(
                "pad_raw_to_bucket got no images: serving batches are "
                "non-empty by construction"
            )
        bh, bw = bucket_hw
        canvases = [pad_to_bucket(im, bh, bw) for im in images]
        hw = [(im.shape[0], im.shape[1]) for im in images]
        if n_slots is not None:
            if len(canvases) > n_slots:
                raise ValueError(
                    f"{len(canvases)} images exceed the warmed batch of "
                    f"{n_slots} slots"
                )
            canvases.extend([canvases[-1]] * (n_slots - len(canvases)))
            hw.extend([hw[-1]] * (n_slots - len(hw)))
        return np.stack(canvases), np.asarray(hw, np.int32)

    def enhance_padded(self, images, bucket_hw, n_slots=None, params=None, device=None) -> np.ndarray:
        """:meth:`enhance_padded_async`, waited for: the (n_slots or N, bh,
        bw, 3) uint8 batch, uncropped."""
        return ten2arr(self.enhance_padded_async(images, bucket_hw, n_slots, params, device))

    def warm_padded(self, n_slots: int, bucket_hw, device=None, params=None):
        """Mark the ``(n_slots, bucket_hw)`` batch on ``device`` warm and
        return the callable that serves it, ``serve(images, params=None)``
        -> :meth:`enhance_padded_async`'s result (``params`` defaults to the
        ones given here). The serving warmup runs one probe batch through
        it (``serving/warmup.py``), which builds cuDNN's plans and the
        allocator's blocks for that shape before any request arrives: the
        port's counterpart of the JAX engine's ``aot_compile_padded``."""
        dev = self._dev(device)
        bh, bw = bucket_hw
        with self._keys_lock:
            self._warm.add(("padded", (n_slots, bh, bw, 3), dev))
        bound = params

        def serve(images, params=None):
            return self.enhance_padded_async(
                images, bucket_hw, n_slots, params=bound if params is None else params, device=dev,
            )

        return serve


class InferenceEngine(_ServingEngineBase):
    def __init__(
        self,
        weights=None,
        params: Optional[dict] = None,
        device_preprocess: bool = False,
        device="cuda",
        dtype: torch.dtype = torch.float32,
        quantize: bool = False,
        calib_batches=None,
        spatial_shards: int = 1,
        data_shards: int = 1,
        devices=None,
    ):
        """``weights``: a ``.npz`` (JAX format) or ``.pt`` (reference
        state_dict) path, else the implicit resolution of
        :func:`~waternet_tpu_torch.hub.resolve_weights`. ``params``: a
        loaded state_dict instead of a path (``utils.convert.
        state_dict_from_jax`` makes one from JAX params), or, with
        ``quantize=True``, a qtree of :func:`~waternet_tpu_torch.models.
        quant.quantize_waternet` used as is. ``device`` defaults to CUDA and
        raises if CUDA is missing; ``"cpu"`` only when asked. ``dtype``: the
        model's compute dtype, ``torch.float32`` or ``torch.bfloat16`` (a
        quantized engine runs its int8 convolutions and float32 between
        them). ``quantize=True`` converts the checkpoint to static int8,
        calibrated on the host on ``calib_batches`` ((x, wb, he, gc) float
        tuples) or on synthetic frames.

        ``spatial_shards > 1`` splits each image's height over that many
        devices (H divisible by it, slabs of at least 26 rows);
        ``data_shards > 1`` splits each frame batch over that many. The two
        are mutually exclusive. ``devices``: the mesh's devices (may repeat
        one: the rehearsal layout); by default the first N CUDA devices
        (raising if there are fewer), or N times the CPU for a CPU
        engine. The engine's ``device`` is then the mesh's first."""
        if devices is not None and (spatial_shards > 1 or data_shards > 1):
            device = devices[0]
        self.device = resolve_device(device)
        self.dtype = check_dtype(dtype)
        if calib_batches is not None and not quantize:
            raise ValueError(
                "calib_batches given without quantize=True: the calibration "
                "data would be silently dropped"
            )
        if data_shards > 1 and spatial_shards > 1:
            raise ValueError(
                "data_shards and spatial_shards are mutually exclusive for "
                "now; pick batch scale-out OR single-frame decomposition"
            )
        self.spatial_shards = int(spatial_shards)
        self.data_shards = int(data_shards)
        self.mesh = None
        if self.sharded:
            from waternet_tpu_torch.parallel.mesh import make_mesh

            if devices is None and self.device.type == "cpu":
                devices = [self.device] * (self.spatial_shards * self.data_shards)
            self.mesh = make_mesh(self.data_shards, self.spatial_shards, devices)
            self.device = resolve_device(self.mesh.devices[0, 0])
        if params is None:
            params = resolve_weights(weights)
        if params is None:
            raise FileNotFoundError(
                "No weights found: pass weights=..., set WATERNET_TPU_WEIGHTS, "
                "or place a checkpoint in ./weights (.npz, or the reference's "
                "exported .pt)."
            )
        self.quantized = bool(quantize)
        self._calib = calib_batches
        if quantize and not quant.is_qtree(params):
            params = self._quantize(params)
        self.params = params
        self.model = self._build(params, self.device)
        self.device_preprocess = device_preprocess
        self._init_keys()

    def _quantize(self, params: dict) -> dict:
        return quant.quantize_waternet(params, self._calib, device="cpu")

    def _build_one(self, params, device):
        if self.quantized:
            return quant.QuantWaterNet(params, device)
        return build_model(params, device)

    def _build(self, params, device):
        """The forward on ``device``; a sharded engine's (asked for its own
        device) spans its mesh: one replica per distinct device, run
        through the spatial halo scheme, or, data-sharded, the list of
        ``(device, model)`` per data shard that :meth:`_shard_parts`
        splits a batch over."""
        if not self.sharded or torch.device(device) != self.device:
            return self._build_one(params, device)
        from waternet_tpu_torch.parallel.spatial import spatial_sharded_apply

        replicas = {}
        for d in self.mesh.devices.ravel():
            if d not in replicas:
                replicas[d] = self._build_one(params, d)
        if self.spatial_shards > 1:
            return spatial_sharded_apply(replicas, self.mesh)
        return [(d, replicas[d]) for d in self.mesh.data_devices()]

    def forward(self, x, wb, he, gc) -> torch.Tensor:
        """The model on four float [0, 1] NHWC batches, in the engine's
        dtype; returns float32 on the engine's device."""
        return self._gather([self._run(m, *(p.to(d) for p in parts))
                             for d, m, parts in self._shard_parts(self.model, self.device, x, wb, he, gc)])

    def _run(self, model, x, wb, he, gc) -> torch.Tensor:
        if self.quantized:
            return model(x, wb, he, gc)
        return run_model(model, self.dtype, x, wb, he, gc)

    def _check_height(self, h: int) -> None:
        """Spatial shards need H divisible into slabs of at least 26 rows."""
        if self.spatial_shards > 1:
            from waternet_tpu_torch.parallel.spatial import check_slab

            check_slab(h, self.spatial_shards)

    def _pad_for_shards(self, rgb_batch):
        """-> (padded_batch, n_real). Shards need equal batch slices, so a
        batch that is not a multiple of data_shards is padded by repeating
        the last frame."""
        n = len(rgb_batch)
        if self.data_shards <= 1 or n % self.data_shards == 0:
            return rgb_batch, n
        from waternet_tpu_torch.parallel.mesh import pad_to_multiple

        return pad_to_multiple(np.asarray(rgb_batch), self.data_shards)

    @staticmethod
    def _shard_parts(model, device, *tensors, dim: int = 0):
        """[(device, model, per-shard pieces)] of a batch (its frames along
        ``dim``): one part per data shard of a data-sharded forward (a
        ``(device, model)`` list), or the whole batch on ``device``."""
        if isinstance(model, list):
            chunks = [t.chunk(len(model), dim=dim) for t in tensors]
            return [(d, m, [c[i] for c in chunks]) for i, (d, m) in enumerate(model)]
        return [(device, model, list(tensors))]

    def _gather(self, outs) -> torch.Tensor:
        return outs[0] if len(outs) == 1 else torch.cat([o.to(self.device) for o in outs])

    @torch.inference_mode()
    def enhance_async(self, rgb_batch) -> torch.Tensor:
        """Enqueue the enhancement and return the (N, H, W, 3) float32
        result tensor on the engine's device, without waiting for it (CUDA
        runs asynchronously); :func:`~waternet_tpu_torch.utils.tensor.
        ten2arr` waits and converts. A data-sharded engine preprocesses
        and runs each shard on its own device; a spatially sharded one
        preprocesses the whole batch on its first device."""
        if len(rgb_batch) == 0:
            raise ValueError(
                "enhance_async got an empty batch: enhancement needs at "
                "least one (H, W, 3) frame"
            )
        self._check_height(np.shape(rgb_batch)[1])
        rgb_batch, n_real = self._pad_for_shards(rgb_batch)
        self._note_shape(("native", tuple(np.shape(rgb_batch)), self.device), padded=False)
        model = self.model  # one read: a reload swaps the attribute whole
        if self.device_preprocess:
            rgb = torch.as_tensor(np.ascontiguousarray(rgb_batch, dtype=np.uint8))
            outs = []
            for dev, m, (part,) in self._shard_parts(model, self.device, rgb):
                part = to_device(part, dev)
                wb, gc, he = transform_batch(part)
                x = part.to(torch.float32) / 255.0
                outs.append(self._run(m, x, wb / 255.0, he / 255.0, gc / 255.0))
            return self._gather(outs)[:n_real]
        wb, gc, he = zip(*(transform_np(np.asarray(f)) for f in rgb_batch))
        host = torch.from_numpy(np.stack([np.stack(a) for a in (list(rgb_batch), wb, he, gc)]))
        outs = []
        for dev, m, (part,) in self._shard_parts(model, self.device, host, dim=1):
            planes = to_device(part.contiguous(), dev).to(torch.float32) / 255.0
            outs.append(self._run(m, *planes.unbind(0)))
        return self._gather(outs)[:n_real]

    # ------------------------------------------------------------------
    # The padded entry points: the shape-bucketed serving path
    # ------------------------------------------------------------------

    def preprocess_padded(self, images, bucket_hw, n_slots=None, device=None):
        """Mixed-native-shape uint8 HWC images -> the network's four float32
        input batches ``(x, wb, he, gc)`` at one ``bucket_hw`` canvas shape,
        on ``device`` (default: the engine's).

        WB/GC/CLAHE always run on the host here (cv2, :func:`~waternet_tpu_
        torch.ops.transform.transform_np`), on the NATIVE image: they are
        per-image statistics, so the pad comes after them. Each of the four
        is then reflect-padded bottom/right to ``bucket_hw``, the batch
        padded to ``n_slots`` by repeating the last image, and the four
        uint8 batches go up in one pinned, non-blocking copy."""
        host = self._padded_host_planes(images, bucket_hw, n_slots)
        planes = to_device(torch.from_numpy(host), self._dev(device)).to(torch.float32) / 255.0
        return tuple(planes.unbind(0))

    def _padded_host_planes(self, images, bucket_hw, n_slots) -> np.ndarray:
        """The (4, N, bh, bw, 3) uint8 host planes of :meth:`preprocess_padded`."""
        from waternet_tpu_torch.serving.bucketing import pad_to_bucket

        if not images:
            raise ValueError(
                "preprocess_padded got no images: serving batches are "
                "non-empty by construction"
            )
        bh, bw = bucket_hw
        quads = []
        for im in images:
            wb, gc, he = transform_np(im)
            quads.append(tuple(pad_to_bucket(a, bh, bw) for a in (im, wb, he, gc)))
        if n_slots is not None:
            if len(quads) > n_slots:
                raise ValueError(
                    f"{len(quads)} images exceed the warmed batch of {n_slots} slots"
                )
            quads.extend([quads[-1]] * (n_slots - len(quads)))
        return np.stack([np.stack(arrs) for arrs in zip(*quads)])

    @torch.inference_mode()
    def enhance_padded_async(self, images, bucket_hw, n_slots=None, params=None, device=None):
        """Enqueue the bucketed forward for ``images`` and return the
        (n_slots or N, bh, bw, 3) float32 result on ``device`` without
        waiting for it. Callers crop row ``i`` back to ``images[i].shape``.

        ``params`` is a :meth:`replica_params` model and ``device`` its
        device (a serving replica's placement); by default the engine's own.
        Host-preprocess engines upload :meth:`preprocess_padded`'s planes,
        then run the forward; device-preprocess engines upload the raw canvases and
        their native shapes, run :func:`~waternet_tpu_torch.ops.masked.
        transform_masked_batch`, then the forward (the JAX engine's
        ``_fused_padded``). The bf16 engine's dtype applies to the forward
        only. A sharded engine serves as one replica spanning its mesh
        (``device`` None): a data-sharded one preprocesses each shard on
        its own device (the slot count must divide evenly)."""
        from waternet_tpu_torch.ops.masked import transform_masked_batch

        dev = self._dev(device)
        model = self.model if params is None else params
        bh, bw = bucket_hw
        n = len(images) if n_slots is None else n_slots
        if self.sharded:
            if device is not None and torch.device(device) != self.device:
                raise ValueError(
                    "per-device serving calls are for unsharded engines; a "
                    "sharded engine's forward spans its mesh already"
                )
            if n % self.data_shards:
                raise ValueError(f"{n} slots do not split over data_shards={self.data_shards}")
            self._check_height(bh)
        self._note_shape(("padded", (n, bh, bw, 3), dev), padded=True)
        outs = []
        if self.device_preprocess:
            canvas, hw = self.pad_raw_to_bucket(images, bucket_hw, n_slots)
            for d, m, (part, part_hw) in self._shard_parts(model, dev, torch.from_numpy(canvas),
                                                           torch.from_numpy(hw)):
                rgb = to_device(part, d)
                wb, gc, he = transform_masked_batch(rgb, to_device(part_hw, d))
                x = rgb.to(torch.float32) / 255.0
                outs.append(self._run(m, x, wb / 255.0, he / 255.0, gc / 255.0))
            return self._gather(outs)
        host = torch.from_numpy(self._padded_host_planes(images, bucket_hw, n_slots))
        for d, m, (part,) in self._shard_parts(model, dev, host, dim=1):
            planes = to_device(part.contiguous(), d).to(torch.float32) / 255.0
            outs.append(self._run(m, *planes.unbind(0)))
        return self._gather(outs)


class StudentEngine(_ServingEngineBase):
    """Fast-tier inference engine: the distilled CAN student
    (``models/can.py``), raw uint8 frames in, enhanced uint8 frames out; no
    WB/GC/CLAHE anywhere, on host or device.

    ``weights``/``params`` must name a student explicitly (a ``train
    --distill`` product): the implicit ``./weights`` resolution is the
    quality tier's. Width and depth are inferred from the weights and
    checked against ``CANStudent``, loudly when given WaterNet weights.
    ``quantize=True`` converts the student to static int8
    (:func:`~waternet_tpu_torch.models.quant.quantize_can`), calibrated on
    ``calib_batches`` (raw float frames in [0, 1]) or synthetic frames.
    The engine is one device a replica: the student is never sharded."""

    def __init__(
        self,
        weights=None,
        params: Optional[dict] = None,
        dtype: torch.dtype = torch.float32,
        quantize: bool = False,
        calib_batches=None,
        device="cuda",
    ):
        from waternet_tpu_torch.models.can import can_config_from_params

        self.device = resolve_device(device)
        self.dtype = check_dtype(dtype)
        if calib_batches is not None and not quantize:
            raise ValueError(
                "calib_batches given without quantize=True: the calibration "
                "data would be silently dropped"
            )
        if params is None:
            if weights is None:
                raise FileNotFoundError(
                    "the fast tier needs explicit student weights: pass "
                    "--student-weights (a train --distill product); the "
                    "implicit ./weights resolution is reserved for the "
                    "quality-tier teacher checkpoint"
                )
            params = resolve_weights(weights)
        self.quantized = bool(quantize)
        self._calib = calib_batches
        # Infers (width, depth) and checks the tree fits CANStudent, loudly
        # for WaterNet weights.
        self.width, self.depth = can_config_from_params(params)
        if quantize:
            params = self._quantize(params)
        self.params = params
        self.model = self._build(params, self.device)
        self._init_keys()

    def _quantize(self, params: dict) -> dict:
        from waternet_tpu_torch.models.can import student_state_dict

        return quant.quantize_can(student_state_dict(params), self._calib, device="cpu")

    def _build(self, params, device):
        from waternet_tpu_torch.models.can import build_student

        if self.quantized:
            return quant.QuantCAN(params, device)
        return build_student(params, device, self.dtype)

    @staticmethod
    def _fused(model, rgb_u8: torch.Tensor) -> torch.Tensor:
        """uint8 batch (native or bucket canvas) -> enhanced float32 batch:
        the native and padded paths are this one function."""
        return model(rgb_u8.to(torch.float32) / 255.0)

    @torch.inference_mode()
    def enhance_async(self, rgb_batch) -> torch.Tensor:
        """Enqueue the enhancement and return the (N, H, W, 3) float32 result
        on the engine's device without waiting (the oversize fallback's
        path, one new shape key per unique shape)."""
        if len(rgb_batch) == 0:
            raise ValueError(
                "enhance_async got an empty batch: enhancement needs at "
                "least one (H, W, 3) frame"
            )
        self._note_shape(("native", tuple(np.shape(rgb_batch)), self.device), padded=False)
        rgb = to_device(torch.as_tensor(np.ascontiguousarray(rgb_batch, dtype=np.uint8)), self.device)
        return self._fused(self.model, rgb)

    @torch.inference_mode()
    def enhance_padded_async(self, images, bucket_hw, n_slots=None, params=None, device=None):
        """Enqueue the bucketed student forward and return the (n_slots or
        N, bh, bw, 3) float32 batch without waiting; callers crop row ``i``
        back to ``images[i].shape``. Padding is reflect, bottom/right; the
        student has no per-image statistics, so the pad touches only the
        seam band within :func:`~waternet_tpu_torch.models.can.
        can_receptive_radius` (64 px at depth 7, against WaterNet's 13)."""
        dev = self._dev(device)
        model = self.model if params is None else params
        bh, bw = bucket_hw
        n = len(images) if n_slots is None else n_slots
        self._note_shape(("padded", (n, bh, bw, 3), dev), padded=True)
        canvas, _ = self.pad_raw_to_bucket(images, bucket_hw, n_slots)
        return self._fused(model, to_device(torch.from_numpy(canvas), dev))
