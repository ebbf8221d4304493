"""``dwconv3x3_kernel``'s device milliseconds a frame: the profiler's
seconds of Restormer's depthwise 3x3 kernel, both epilogues (MDTA's
identity and GDFN's GELU gate), over the device-only half's frames, as
``conv_bias_act_ms_per_frame.video`` reads its kernel. A program without
the kernel (its depthwise convs in ATen's and cuDNN's kernels) gives
None."""

from perfbench.profiling import kernel_seconds


def read(run):
    frames = run.profile_units.get("device")
    if not run.profile or not frames:
        return None
    n, sec = kernel_seconds(run.profile, "dwconv3x3_kernel")
    return sec * 1e3 / frames if n else None
