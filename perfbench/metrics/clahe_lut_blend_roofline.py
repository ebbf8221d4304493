"""``clahe_lut_blend_kernel``'s share of its roofline: one launch a call
over the call's L planes."""

from perfbench.counts import kernels
from perfbench.metrics._roofline import share


def read(run):
    h, w = run.host["frame_shape"]
    return share(run, "clahe_lut_blend_kernel", kernels.clahe_lut_blend(run.mix["frames_per_call"], h, w))
