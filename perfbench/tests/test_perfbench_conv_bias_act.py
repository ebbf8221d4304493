"""The reader of ``conv_bias_act_ms_per_frame.video`` on synthetic
profiles: the kernel's device seconds over the device-only half's frames,
and nothing where the program has no such kernel."""

import pytest

from perfbench import harness
from perfbench.tests.helpers import SEED, TINY

CELL = "waternet.video_1080p"
METRIC = "conv_bias_act_ms_per_frame.video"
KERNEL = "void (anonymous namespace)::conv_bias_act_kernel<__nv_bfloat16, 0, 8>(__nv_bfloat16*, ...)"
SIGMOID = "void (anonymous namespace)::conv_bias_act_kernel<__nv_bfloat16, 1, 8>(__nv_bfloat16*, ...)"


def _run(profile, device_frames=40):
    run = harness.Run(harness.Cell(CELL, overrides=TINY[CELL]), SEED, 1.0, True, "cpu")
    run.profile = profile
    run.profile_units = {"device": device_frames, "host": device_frames}
    return run


def test_reader_sums_the_kernels_instances_over_the_frames():
    """Every instantiation counts (ReLU and sigmoid); ATen's own bias adds
    and activations, and the convolutions, do not."""
    profile = {"kernels": {KERNEL: [160, 0.080], SIGMOID: [10, 0.004],
                           "void at::native::elementwise_kernel<128, 4, ...>": [170, 0.186],
                           "sm90_xmma_fprop_implicit_gemm_bf16bf16": [170, 0.5]}}
    assert harness.read_metric(_run(profile), METRIC) == pytest.approx(84.0 / 40)


def test_reader_gives_none_without_the_kernel_or_a_profile():
    """The parent's program (bias and activation in ATen's passes), an
    untraced run and a profiled half with no frames leave the metric out."""
    aten = {"kernels": {"void at::native::elementwise_kernel<128, 4, ...>": [170, 0.186]}}
    assert harness.read_metric(_run(aten), METRIC) is None
    assert harness.read_metric(_run(None), METRIC) is None
    assert harness.read_metric(_run({"kernels": {KERNEL: [1, 0.001]}}, 0), METRIC) is None
