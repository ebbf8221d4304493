"""The window's training steps/s times one step's FLOPs (WaterNet forward
and backward and the VGG19 perceptual terms, ``perfbench/counts/
flops.py``) over the card's bf16 dense peak, in percent."""

from perfbench.counts import flops


def read(run):
    peak = run.peak("bf16_flops_per_s")
    if peak is None or not run.host.get("steps"):
        return None
    b, h, w = run.host["step_shape"]
    step = flops.waternet_train_step(run.config, b, h, w, perceptual=True)
    return 100.0 * run.host["steps"] / run.host["window_s"] * step / peak
