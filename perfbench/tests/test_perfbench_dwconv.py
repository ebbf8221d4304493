"""The reader of ``dwconv_ms_per_frame.restormer`` on synthetic profiles:
the depthwise kernel's device seconds, both epilogues, over the device-only
half's frames, and nothing where the program has no such kernel."""

import pytest

from perfbench import harness
from perfbench.tests.helpers import SEED

CELL = "restormer.video_1080p"
METRIC = "dwconv_ms_per_frame.restormer"
IDENTITY = "void (anonymous namespace)::dwconv3x3_kernel<__nv_bfloat16, 0, true>(const __nv_bfloat16*, ...)"
GATE = "void (anonymous namespace)::dwconv3x3_kernel<__nv_bfloat16, 1, true>(const __nv_bfloat16*, ...)"
ATEN = "void at::native::(anonymous namespace)::conv_depthwise2d_forward_kernel<3, c10::BFloat16, int>(...)"
CUDNN = "conv2d_c1_k1_nchw_shmem_tiling"


def _run(profile, device_frames=8):
    run = harness.Run(harness.Cell(CELL), SEED, 1.0, True, "cpu")
    run.profile = profile
    run.profile_units = {"device": device_frames, "host": device_frames}
    return run


def test_reader_sums_both_epilogues_over_the_frames():
    """MDTA's identity and GDFN's gate count; ATen's and cuDNN's depthwise
    kernels, the LayerNorm and the GEMMs do not."""
    profile = {"kernels": {IDENTITY: [88, 0.096], GATE: [88, 0.160], ATEN: [72, 0.9],
                           CUDNN: [16, 0.26], "vectorized_layer_norm_kernel": [176, 0.6]}}
    assert harness.read_metric(_run(profile), METRIC) == pytest.approx(256.0 / 8)


def test_reader_gives_none_without_the_kernel_or_a_profile():
    """The parent's program (ATen's and cuDNN's depthwise kernels), an
    untraced run and a profiled half with no frames leave the metric out."""
    parent = {"kernels": {ATEN: [72, 0.9], CUDNN: [16, 0.26]}}
    assert harness.read_metric(_run(parent), METRIC) is None
    assert harness.read_metric(_run(None), METRIC) is None
    assert harness.read_metric(_run({"kernels": {GATE: [1, 0.001]}}, 0), METRIC) is None
