"""WaterNet on PyTorch and CUDA (Hopper): the port of ``waternet_tpu``.

The JAX package ``waternet_tpu`` stays the reference; this package mirrors
its module names so each counterpart is easy to find, and imports nothing
of it (nor ``jax``/``flax``). Public functions keep the JAX package's NHWC
layout, (N, H, W, 3) uint8 in and out; the model permutes to NCHW inside.

Entry points (:class:`~waternet_tpu_torch.inference_engine.InferenceEngine`,
:func:`~waternet_tpu_torch.hub.waternet`, ``python -m
waternet_tpu_torch.inference``) run on ``device="cuda"`` unless the caller
asks for ``"cpu"``. The two CLAHE kernels on the serving path are CUDA C++
for ``sm_90a`` (``csrc/clahe.cu``), built with nvcc at first use; on a CPU
tensor their wrappers run the plain PyTorch versions instead
(:mod:`waternet_tpu_torch.ops.kernels`).
"""
