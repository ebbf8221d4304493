"""Floating-point operations of the benchmark's networks, from their layer
lists: 2 per multiply-add of every convolution; activations, pools,
losses and the optimizer are left out (under 1% of any step here)."""

from __future__ import annotations

from perfbench.reference.nets import vgg19_layers


def conv(h: int, w: int, cin: int, cout: int, k: int) -> int:
    """One SAME k x k convolution over an h x w plane (dilation does not
    change the count)."""
    return 2 * h * w * cin * cout * k * k


def waternet_forward(cfg: dict, h: int, w: int) -> int:
    """One image's forward: the confidence-map generator and each refiner."""
    cmg = sum(conv(h, w, *layer) for layer in cfg["cmg"])
    refiner = sum(conv(h, w, *layer) for layer in cfg["refiner"])
    return cmg + len(cfg["refiners"]) * refiner


def can_forward(cfg: dict, h: int, w: int) -> int:
    total, cin = 0, 3
    for _ in range(cfg["depth"]):
        total += conv(h, w, cin, cfg["width"], 3)
        cin = cfg["width"]
    return total + conv(h, w, cin, 3, 1)


def forward(cfg: dict, h: int, w: int) -> int:
    """One image's forward of the configuration's network."""
    return {"waternet": waternet_forward, "can": can_forward}[cfg["arch"]](cfg, h, w)


def vgg19_forward(h: int, w: int) -> int:
    """VGG19's 16 convolutions through relu5_4, halving the plane after
    convolutions 2, 4, 8 and 12."""
    total = 0
    for i, (_, cin, cout) in enumerate(vgg19_layers()):
        total += conv(h, w, cin, cout, 3)
        if i in (1, 3, 7, 11):
            h, w = h // 2, w // 2
    return total


def waternet_train_step(cfg: dict, batch: int, h: int, w: int, perceptual: bool) -> int:
    """One training step of ``batch`` images: WaterNet's forward, its
    weight gradients, and its input gradients for every convolution whose
    input depends on the weights (not the first of the generator or of a
    refiner, which read data); with the perceptual term, VGG19 forward on
    the output and on the reference, and its input gradients back to the
    output (VGG19 is frozen: no weight gradients)."""
    fwd = waternet_forward(cfg, h, w)
    data_fed = conv(h, w, *cfg["cmg"][0]) + len(cfg["refiners"]) * conv(h, w, *cfg["refiner"][0])
    total = 3 * fwd - data_fed
    if perceptual:
        total += 3 * vgg19_forward(h, w)
    return batch * total
