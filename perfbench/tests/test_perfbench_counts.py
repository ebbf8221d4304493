"""The FLOP and byte counts against hand counts."""

import pytest

from perfbench import harness
from perfbench.counts import flops, kernels

WATERNET = harness.load_json(harness.ROOT / "configs" / "waternet.json")
CAN24 = harness.load_json(harness.ROOT / "configs" / "can24.json")


def test_waternet_forward():
    # Generator: 12*128*49 + 128*128*25 + 128*128*9 + 128*64 + 64*64*49
    # + 64*64*25 + 64*64*9 + 64*3*9 = 982,208 MACs a pixel; a refiner
    # 6*32*49 + 32*32*25 + 32*3*9 = 35,872; three of them.
    assert flops.forward(WATERNET, 1, 1) == 2 * (982_208 + 3 * 35_872) == 2 * 1_089_824
    assert flops.forward(WATERNET, 1080, 1920) == 2 * 1_089_824 * 1080 * 1920


def test_can24_forward():
    # 3*24*9 + 6 * 24*24*9 + 24*3 = 31,824 MACs a pixel.
    assert flops.forward(CAN24, 1, 1) == 2 * 31_824
    assert flops.forward(CAN24, 1080, 1920) == 2 * 31_824 * 1080 * 1920


def test_vgg19_through_relu5_4():
    macs = (224 * 224 * (3 * 64 + 64 * 64) + 112 * 112 * (64 * 128 + 128 * 128)
            + 56 * 56 * (128 * 256 + 3 * 256 * 256) + 28 * 28 * (256 * 512 + 3 * 512 * 512)
            + 14 * 14 * 4 * 512 * 512) * 9
    assert macs == 19_508_428_800  # VGG19's 19.5 G multiply-adds, less its classifier
    assert flops.vgg19_forward(224, 224) == 2 * macs


def test_train_step():
    fwd = flops.forward(WATERNET, 256, 256)
    first = flops.conv(256, 256, 12, 128, 7) + 3 * flops.conv(256, 256, 6, 32, 7)
    step = 8 * (3 * fwd - first + 3 * flops.vgg19_forward(256, 256))
    assert flops.waternet_train_step(WATERNET, 8, 256, 256, perceptual=True) == step
    assert flops.waternet_train_step(WATERNET, 8, 256, 256, perceptual=False) == 8 * (3 * fwd - first)


def test_kernel_bytes_at_the_main_shapes():
    # 4 x 1080x1920 L planes (no padding: both divide by 8) in, 4 x 64
    # tables of 256 float32 out.
    assert kernels.tile_lut(4, 1080, 1920)["bytes"] == 4 * 1080 * 1920 + 4 * 64 * 256 * 4 == 8_556_544
    # Tables and planes in, two row and two column index vectors (int32)
    # and the two weight vectors (float32) in, float32 planes out.
    blend = 4 * 64 * 1024 + 4 * 1080 * 1920 + 4 * (2 * 1080 + 2 * 1920) + 4 * (1080 + 1920) + 4 * 1080 * 1920 * 4
    assert kernels.clahe_lut_blend(4, 1080, 1920)["bytes"] == blend == 41_770_144
    # T1's decode: 2 x 8 images of 32 x 32 blocks, 3 channels, 16 int8
    # coefficients each; the two tables; uint8 pixels out.
    nb = 16 * 32 * 32 * 3
    d = kernels.dct8_decode_u8(16, 256, 256)
    assert d["bytes"] == nb * 16 + 64 + 4096 + 16 * 256 * 256 * 3 == 3_936_320
    assert d["ops"] == nb * 2064 + 4 * 16 * 256 * 256 * 3
    # The kernel table's bounds (PERF.md): 0.00255, 0.01247 and 0.00170 ms.
    assert kernels.least_seconds(kernels.tile_lut(4, 1080, 1920), 3.35e12, 67e12) == pytest.approx(2.554e-6, rel=1e-3)
    assert kernels.least_seconds(kernels.clahe_lut_blend(4, 1080, 1920), 3.35e12, 67e12) == pytest.approx(
        1.2469e-5, rel=1e-3)
    assert kernels.least_seconds(d, 3.35e12, 67e12) == pytest.approx(1.702e-6, rel=1e-3)


def test_clahe_padding():
    assert kernels.clahe_padded(1080, 1920) == (1080, 1920)
    assert kernels.clahe_padded(1087, 1447) == (1088, 1448)
    assert kernels.clahe_padded(1088, 1447) == (1096, 1448)  # OpenCV pads both when either is off
