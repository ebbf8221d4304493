"""``dct8_decode_u8_kernel``'s share of its roofline: one launch a step,
decoding the batch's raw and reference images together."""

from perfbench.counts import kernels
from perfbench.metrics._roofline import share


def read(run):
    b, h, w = run.host["decode_shape"]
    return share(run, "dct8_decode_u8_kernel", kernels.dct8_decode_u8(b, h, w))
