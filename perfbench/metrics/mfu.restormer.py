"""The window's frames/s times one frame's forward FLOPs
(``perfbench/counts/restormer.py``) over the card's bf16 dense peak, in
percent."""

from perfbench.counts import restormer


def read(run):
    peak = run.peak("bf16_flops_per_s")
    if peak is None or not run.host.get("frames"):
        return None
    h, w = run.host["frame_shape"]
    rate = run.host["frames"] / run.host["window_s"]
    return 100.0 * rate * restormer.forward(run.config, h, w) / peak
