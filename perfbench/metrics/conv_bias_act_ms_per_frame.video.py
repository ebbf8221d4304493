"""``conv_bias_act_kernel``'s device milliseconds a frame: the profiler's
seconds of the forward's bias-and-activation kernel over the device-only
half's frames, as ``readback_device_ms_per_frame`` reads ``Memcpy DtoH``.
A program without the kernel (its bias adds and activations run in ATen's
own passes) gives None."""

from perfbench.profiling import kernel_seconds


def read(run):
    frames = run.profile_units.get("device")
    if not run.profile or not frames:
        return None
    n, sec = kernel_seconds(run.profile, "conv_bias_act_kernel")
    return sec * 1e3 / frames if n else None
