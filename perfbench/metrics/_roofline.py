"""A kernel's share of its roofline in the profiled sub-window: its
launches times the least time the card could take for one launch (bytes
over the memory rate or operations over the float32 rate, from
``perfbench/counts/kernels.py`` at the launch's shape), over the kernel's
device seconds, in percent."""

from perfbench import profiling
from perfbench.counts import kernels


def share(run, fragment: str, count: dict):
    if not run.profile:
        return None
    launches, sec = profiling.kernel_seconds(run.profile, fragment)
    hbm, fp32 = run.peak("hbm_bytes_per_s"), run.peak("fp32_flops_per_s")
    if not launches or not sec or hbm is None:
        return None
    return 100.0 * launches * kernels.least_seconds(count, hbm, fp32) / sec
