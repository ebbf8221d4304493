"""Bytes and operations of the program's hand-written kernels, from the
shapes they are launched at. Each input byte counts as read once and each
output byte as written once, whatever the kernel reads again; operations
count float32 arithmetic. A kernel's least time is the larger of the
bytes over the card's memory rate and the operations over its float32
rate."""

from __future__ import annotations

LUT_BYTES = 8 * 8 * 256 * 4  # one image's 8 x 8 float32 tile tables


def clahe_padded(h: int, w: int, tiles: int = 8):
    """(hp, wp): CLAHE's padded plane (both axes padded by ``tiles - size %
    tiles`` when either is not a multiple of ``tiles``)."""
    if h % tiles == 0 and w % tiles == 0:
        return h, w
    return h + tiles - h % tiles, w + tiles - w % tiles


def tile_lut(n: int, h: int, w: int) -> dict:
    """Per-tile histograms, clip and tables of ``n`` L planes: the padded
    uint8 planes in, the float32 tables out."""
    hp, wp = clahe_padded(h, w)
    return {"bytes": n * hp * wp + n * LUT_BYTES, "ops": 0}


def clahe_lut_blend(n: int, h: int, w: int) -> dict:
    """The four-table lookup and bilinear blend of ``n`` planes: tables,
    padded planes, the row and column tile indices and blend weights in,
    the float32 h x w planes out; 12 operations a pixel (two blends of
    two, one of two, the round and the clamp)."""
    hp, wp = clahe_padded(h, w)
    index_bytes = 4 * (2 * hp + 2 * wp) + 4 * (h + w)
    return {"bytes": n * LUT_BYTES + n * hp * wp + index_bytes + n * h * w * 4, "ops": 12 * n * h * w}


def dct8_decode_u8(b: int, h: int, w: int, c: int = 3) -> dict:
    """The dct8 decode of ``b`` images: int8 4x4-zone coefficients of every
    8 x 8 block and channel, the quantization table and the 16 x 64
    inverse-transform matrix in, uint8 pixels out; per block-channel 16
    multiplies and a 16 x 64 product, and 4 operations a pixel for the
    shift, round and clamp."""
    nb = b * (-(-h // 8)) * (-(-w // 8)) * c
    out = b * h * w * c
    return {"bytes": nb * 16 + 16 * 4 + 16 * 64 * 4 + out, "ops": nb * (16 + 2 * 16 * 64) + 4 * out}


def least_seconds(count: dict, hbm_bytes_per_s: float, fp32_flops_per_s: float) -> float:
    return max(count["bytes"] / hbm_bytes_per_s, count["ops"] / fp32_flops_per_s)
