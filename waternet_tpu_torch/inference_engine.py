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
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from waternet_tpu_torch.hub import build_model, check_dtype, resolve_weights, run_model
from waternet_tpu_torch.ops.transform import transform_batch, transform_np
from waternet_tpu_torch.utils.device import resolve_device
from waternet_tpu_torch.utils.tensor import ten2arr, to_device


class InferenceEngine:
    def __init__(
        self,
        weights=None,
        params: Optional[dict] = None,
        device_preprocess: bool = False,
        device="cuda",
        dtype: torch.dtype = torch.float32,
    ):
        """``weights``: a ``.npz`` (JAX format) or ``.pt`` (reference
        state_dict) path, else the implicit resolution of
        :func:`~waternet_tpu_torch.hub.resolve_weights`. ``params``: a
        loaded state_dict instead of a path (``utils.convert.
        state_dict_from_jax`` makes one from JAX params). ``device``
        defaults to CUDA and raises if CUDA is missing; ``"cpu"`` only when
        asked. ``dtype``: the model's compute dtype, ``torch.float32`` or
        ``torch.bfloat16``."""
        self.device = resolve_device(device)
        self.dtype = check_dtype(dtype)
        if params is None:
            params = resolve_weights(weights)
        if params is None:
            raise FileNotFoundError(
                "No weights found: pass weights=..., set WATERNET_TPU_WEIGHTS, "
                "or place a checkpoint in ./weights (.npz, or the reference's "
                "exported .pt)."
            )
        self.model = build_model(params, self.device)
        self.device_preprocess = device_preprocess

    def enhance(self, rgb_batch) -> np.ndarray:
        """(N, H, W, 3) uint8 RGB -> (N, H, W, 3) uint8 RGB enhanced."""
        return ten2arr(self.enhance_async(rgb_batch))

    def forward(self, x, wb, he, gc) -> torch.Tensor:
        """The model on four float [0, 1] NHWC batches, in the engine's
        dtype; returns float32."""
        return run_model(self.model, self.dtype, x, wb, he, gc)

    @torch.inference_mode()
    def enhance_async(self, rgb_batch) -> torch.Tensor:
        """Enqueue the enhancement and return the (N, H, W, 3) float32
        result tensor on the engine's device, without waiting for it (CUDA
        runs asynchronously); :func:`~waternet_tpu_torch.utils.tensor.
        ten2arr` waits and converts."""
        if len(rgb_batch) == 0:
            raise ValueError(
                "enhance_async got an empty batch: enhancement needs at "
                "least one (H, W, 3) frame"
            )
        if self.device_preprocess:
            rgb = torch.as_tensor(np.ascontiguousarray(rgb_batch, dtype=np.uint8))
            rgb = to_device(rgb, self.device)
            wb, gc, he = transform_batch(rgb)
            x = rgb.to(torch.float32) / 255.0
            return self.forward(x, wb / 255.0, he / 255.0, gc / 255.0)
        wb, gc, he = zip(*(transform_np(np.asarray(f)) for f in rgb_batch))

        def to_dev(arrs):
            t = to_device(torch.from_numpy(np.stack(arrs)), self.device)
            return t.to(torch.float32) / 255.0

        return self.forward(to_dev(list(rgb_batch)), to_dev(wb), to_dev(he), to_dev(gc))
