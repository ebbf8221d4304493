"""8-bit RGB <-> CIELAB.

:func:`rgb_to_lab_u8` replicates OpenCV's uint8 fixed-point ``RGB2Lab_b``
pipeline exactly, as the JAX package does (waternet_tpu/ops/color.py:
145-207): a 256-entry sRGB gamma table scaled by 8, a 12-bit fixed-point
XYZ matrix with the D65 whitepoint folded in, a 3072-entry cube-root
table scaled by 2^15 and ``CV_DESCALE`` rounding. Tables are built in
numpy float32 (OpenCV's softfloat is IEEE binary32); intermediates stay
int32, whose ``>>`` is arithmetic in torch as in ``jnp.right_shift``.

:func:`lab_u8_to_rgb` is the float inverse with the default ``poly``
linear->sRGB transfer (a degree-10 polynomial in ``x ** 0.25``). Its
float chain may round differently from XLA's (which may contract
multiply-adds), so it is held to the JAX path within one level.
``WATERNET_SRGB_TRANSFER=float`` selects the literal ``pow(x, 1/2.4)``
transfer instead, the JAX package's A/B mode, read at each call.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

_RGB2XYZ = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ],
    dtype=np.float32,
)
_XYZ2RGB = np.array(
    [
        [3.240479, -1.537150, -0.498535],
        [-0.969256, 1.875992, 0.041556],
        [0.055648, -0.204043, 1.057311],
    ],
    dtype=np.float32,
)
_WHITE = np.array([0.950456, 1.0, 1.088754], dtype=np.float32)
_LAB_T0 = 0.008856
_LAB_K = 7.787
_SRGB_CUT = 0.0031308


def _build_srgb_poly():
    """Degree-10 fit of ``t -> t**(5/3)`` on ``[cut**0.25, 1]``, power basis
    in the Chebyshev window variable; with ``t = x**0.25`` it approximates
    ``x**(1/2.4)`` to float32 rounding."""
    a = _SRGB_CUT**0.25
    ch = np.polynomial.chebyshev.Chebyshev.interpolate(
        lambda t: t ** (5.0 / 3.0), 10, domain=[a, 1.0]
    )
    coef = np.polynomial.chebyshev.cheb2poly(ch.coef).astype(np.float32)
    scale = np.float32(2.0 / (1.0 - a))
    offset = np.float32(-(1.0 + a) / (1.0 - a))
    return coef, scale, offset


_SRGB_POLY_COEF, _SRGB_POLY_SCALE, _SRGB_POLY_OFFSET = _build_srgb_poly()

_GAMMA_SHIFT = 3
_LAB_FP_SHIFT = 12
_LAB_FP_SHIFT2 = _LAB_FP_SHIFT + _GAMMA_SHIFT  # 15


def _build_u8_tables():
    i = np.arange(256, dtype=np.float32)
    x = i / np.float32(255.0)
    g = np.where(
        x <= np.float32(0.04045),
        x / np.float32(12.92),
        np.power((x + np.float32(0.055)) / np.float32(1.055), np.float32(2.4)),
    )
    gamma_tab = np.rint(
        255.0 * (1 << _GAMMA_SHIFT) * g.astype(np.float64)
    ).astype(np.int32)

    n = 256 * 3 // 2 * (1 << _GAMMA_SHIFT)  # 3072
    xx = np.arange(n, dtype=np.float32) / np.float32(255 * (1 << _GAMMA_SHIFT))
    f = np.where(
        xx < np.float32(216.0 / 24389.0),
        np.float32(841.0 / 108.0) * xx + np.float32(16.0 / 116.0),
        np.cbrt(xx),
    )
    cbrt_tab = np.rint(
        float(1 << _LAB_FP_SHIFT2) * f.astype(np.float64)
    ).astype(np.int32)

    coeffs = np.rint(
        (1 << _LAB_FP_SHIFT)
        * _RGB2XYZ.astype(np.float64)
        / _WHITE[:, None].astype(np.float64)
    ).astype(np.int32)
    return gamma_tab, cbrt_tab, coeffs


_U8_GAMMA_TAB, _U8_CBRT_TAB, _U8_XYZ_COEFFS = _build_u8_tables()
_U8_LSCALE = (116 * 255 + 50) // 100  # 296
_U8_LSHIFT = -((16 * 255 * (1 << _LAB_FP_SHIFT2) + 50) // 100)


@functools.lru_cache(maxsize=None)
def _u8_tables(device: torch.device):
    """The two lookup tables on ``device``, copied once per device."""
    return (
        # jaxlint: disable-next=R003 first-call table (lru_cache per device): a blocking copy, safe on every stream
        torch.from_numpy(_U8_GAMMA_TAB).to(device),
        # jaxlint: disable-next=R003 first-call table (lru_cache per device): a blocking copy, safe on every stream
        torch.from_numpy(_U8_CBRT_TAB).to(device),
    )


def _descale(v, n):
    # CV_DESCALE: round-to-nearest via add-half then arithmetic shift.
    return (v + (1 << (n - 1))) >> n


def rgb_to_lab_u8(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8-valued RGB -> (..., 3) float32 8-bit LAB values (L
    scaled *255/100, a/b offset by +128): bit-exact vs ``cv2.cvtColor(...,
    COLOR_RGB2LAB)``."""
    gamma, cbrt = _u8_tables(rgb.device)
    v = rgb.long()
    r, g, b = gamma[v[..., 0]], gamma[v[..., 1]], gamma[v[..., 2]]
    c = _U8_XYZ_COEFFS

    def frow(i):
        acc = r * int(c[i, 0]) + g * int(c[i, 1]) + b * int(c[i, 2])
        return cbrt[_descale(acc, _LAB_FP_SHIFT).long()]

    fx, fy, fz = frow(0), frow(1), frow(2)
    lum = _descale(_U8_LSCALE * fy + _U8_LSHIFT, _LAB_FP_SHIFT2)
    a = _descale(500 * (fx - fy) + (128 << _LAB_FP_SHIFT2), _LAB_FP_SHIFT2)
    bb = _descale(200 * (fy - fz) + (128 << _LAB_FP_SHIFT2), _LAB_FP_SHIFT2)
    lab = torch.stack([lum, a, bb], dim=-1)
    return torch.clamp(lab, 0, 255).to(torch.float32)


def _srgb_transfer_mode() -> str:
    """The linear->sRGB transfer ``WATERNET_SRGB_TRANSFER`` selects:
    ``poly`` (default, the sqrt + Horner path) or ``float`` (the literal
    ``pow(x, 1/2.4)`` formula, kept for A/B measurement). Anything else
    raises: a typo must not silently change the measured path."""
    mode = os.environ.get("WATERNET_SRGB_TRANSFER", "poly").strip().lower()
    if mode not in ("poly", "float"):
        raise ValueError(f"WATERNET_SRGB_TRANSFER={mode!r}: expected 'poly' or 'float'")
    return mode


def _linear_to_srgb(v):
    if _srgb_transfer_mode() == "float":
        return torch.where(
            v > _SRGB_CUT,
            1.055 * torch.pow(torch.clamp(v, min=0.0), 1.0 / 2.4) - 0.055,
            12.92 * v,
        )
    # poly: clamp to [cut, 1] (x > 1 clips to 255 downstream either way; p(1) is
    # 1.0 exactly), substitute t = x**0.25 (two sqrts), Horner in the
    # window variable.
    t = torch.sqrt(torch.sqrt(torch.clamp(v, _SRGB_CUT, 1.0)))
    s = t * float(_SRGB_POLY_SCALE) + float(_SRGB_POLY_OFFSET)
    acc = torch.full_like(s, float(_SRGB_POLY_COEF[-1]))
    for k in range(len(_SRGB_POLY_COEF) - 2, -1, -1):
        acc = acc * s + float(_SRGB_POLY_COEF[k])
    return torch.where(v > _SRGB_CUT, 1.055 * acc - 0.055, 12.92 * v)


def _lab_f_inv(f):
    t3 = f * f * f
    return torch.where(t3 > _LAB_T0, t3, (f - 16.0 / 116.0) / _LAB_K)


def lab_u8_to_rgb(lab: torch.Tensor) -> torch.Tensor:
    """(..., 3) float32 8-bit LAB values -> (..., 3) float32 uint8-valued RGB."""
    lum = lab[..., 0] * 100.0 / 255.0
    a = lab[..., 1] - 128.0
    b = lab[..., 2] - 128.0
    fy = (lum + 16.0) / 116.0
    f = torch.stack([fy + a / 500.0, fy, fy - b / 200.0], dim=-1)
    finv = _lab_f_inv(f)
    x, y, z = (finv[..., k] * float(_WHITE[k]) for k in range(3))
    m = _XYZ2RGB
    rgb_lin = torch.stack(
        [x * float(m[k, 0]) + y * float(m[k, 1]) + z * float(m[k, 2]) for k in range(3)],
        dim=-1,
    )
    rgb = _linear_to_srgb(rgb_lin)
    return torch.clamp(torch.round(rgb * 255.0), 0.0, 255.0)
