"""Cache codecs: the dataset held on the device, encoded, and decoded in
the step.

Own copy of the JAX package's ``data/codec.py``. The host encoders are
numpy and give byte-identical payloads; the device decoders are torch:

* ``raw``    uint8 as is: 1x, no decode.
* ``yuv420`` BT.601 full-range YCbCr with 2x2 box-mean chroma: 2x. Decode:
  nearest-neighbour chroma upsample, one 3x3 matrix per pixel.
* ``dct8``   8x8 blockwise orthonormal DCT, the 4x4 low-frequency zone
  kept, int8 under :data:`DCT8_QUANT`: 4x. Decode: one launch of the
  ``dct8_decode_u8`` kernel (:mod:`waternet_tpu_torch.ops.kernels`):
  dequantize, inverse DCT, relayout to pixels and ``clip(round(x + 128))``.

Both lossy decoders emit uint8. The f32 pixel blocks differ from the JAX
decode only by the summation order of XLA's matmul, so the uint8 may
differ by one level where ``x + 128`` lies next to a rounding tie.

The preflight budgeter sizes a cache against the device's headroom
before a byte is pinned: per-codec estimates, the ``auto`` choice (the
cheapest decode that fits), the ``--cache-report`` table and the sized
:class:`CacheBudgetError`. ``WATERNET_CACHE_HEADROOM_BYTES`` overrides the
live headroom.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, List, Optional

import numpy as np
import torch

CODECS = ("raw", "yuv420", "dct8")

#: Share of the headroom the budgeter commits to a cache; the rest stays
#: for activations and fragmentation.
HEADROOM_SAFETY = 0.9

#: dct8 zonal keep: the low-frequency ZONE x ZONE corner of each 8x8 block.
DCT8_ZONE = 4

#: Quantization table over the kept zone, row-major: q[u, v] = 8 + 2 (u + v).
DCT8_QUANT = np.array(
    [[8.0 + 2.0 * (u + v) for v in range(DCT8_ZONE)] for u in range(DCT8_ZONE)],
    np.float32,
).reshape(-1)

# BT.601 full-range (JPEG) RGB<->YCbCr constants.
_YCBCR_FWD = np.array(
    [
        [0.299, 0.587, 0.114],
        [-0.168736, -0.331264, 0.5],
        [0.5, -0.418688, -0.081312],
    ],
    np.float32,
)
_YCBCR_INV = np.array(
    [
        [1.0, 0.0, 1.402],
        [1.0, -0.344136, -0.714136],
        [1.0, 1.772, 0.0],
    ],
    np.float32,
)


class CacheBudgetError(RuntimeError):
    """The device cache would not fit: a sized message that names the
    cheapest codec that would fit, where one exists."""


def _dct_basis() -> np.ndarray:
    """Orthonormal 8-point DCT-II basis A: ``coeff = A @ x``."""
    k = np.arange(8, dtype=np.float64)
    a = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16.0)
    a *= np.sqrt(2.0 / 8.0)
    a[0] *= np.sqrt(0.5)
    return a.astype(np.float32)


DCT8_BASIS = _dct_basis()


def _idct_matrix() -> np.ndarray:
    """(16, 64) float32 ``M[(u, v), (x, y)] = A[u, x] * A[v, y]``: decode
    is ``pixels = (coeff * q) @ M``."""
    a = DCT8_BASIS.astype(np.float64)
    m = np.einsum("ux,vy->uvxy", a[:DCT8_ZONE], a[:DCT8_ZONE])
    return m.reshape(DCT8_ZONE * DCT8_ZONE, 64).astype(np.float32)


DCT8_IDCT_MATRIX = _idct_matrix()


# ---------------------------------------------------------------------------
# Host encoders (numpy, at cache build)
# ---------------------------------------------------------------------------


def _pad_to_multiple_np(img: np.ndarray, mult: int) -> np.ndarray:
    """Edge-replicate H/W of (N, H, W, C) up to multiples of ``mult``."""
    _, h, w, _ = img.shape
    ph, pw = (-h) % mult, (-w) % mult
    if ph or pw:
        img = np.pad(img, ((0, 0), (0, ph), (0, pw), (0, 0)), mode="edge")
    return img


def _check_codec(codec: str) -> None:
    if codec not in CODECS:
        raise ValueError(f"unknown cache codec {codec!r} (choose from {CODECS})")


def encode(codec: str, u8: np.ndarray) -> Dict[str, np.ndarray]:
    """(N, H, W, 3) uint8 -> the codec's payload: a flat name -> array
    dict, each array with the image index first."""
    _check_codec(codec)
    u8 = np.asarray(u8, np.uint8)
    if codec == "raw":
        return {"raw": u8}
    if codec == "yuv420":
        return _encode_yuv420(u8)
    return _encode_dct8(u8)


def _encode_yuv420(u8: np.ndarray) -> Dict[str, np.ndarray]:
    ycc = u8.astype(np.float32) @ _YCBCR_FWD.T
    ycc[..., 1:] += 128.0
    y = np.clip(np.round(ycc[..., 0]), 0, 255).astype(np.uint8)
    cc = _pad_to_multiple_np(ycc[..., 1:], 2)
    n, hp, wp, _ = cc.shape
    cc = cc.reshape(n, hp // 2, 2, wp // 2, 2, 2).mean(axis=(2, 4))
    cc = np.clip(np.round(cc), 0, 255).astype(np.uint8)
    return {"y": y, "cb": cc[..., 0], "cr": cc[..., 1]}


def _encode_dct8(u8: np.ndarray) -> Dict[str, np.ndarray]:
    x = _pad_to_multiple_np(u8, 8).astype(np.float32)
    x -= 128.0
    n, hp, wp, c = x.shape
    blocks = x.reshape(n, hp // 8, 8, wp // 8, 8, c).transpose(0, 1, 3, 5, 2, 4)
    a, z = DCT8_BASIS, DCT8_ZONE
    coef = np.einsum("ux,vy,...xy->...uv", a[:z], a[:z], blocks)
    coef = coef.reshape(coef.shape[:-2] + (z * z,)) / DCT8_QUANT
    coef = np.clip(np.round(coef), -127, 127).astype(np.int8)
    return {"coef": coef}  # (N, nby, nbx, C, 16) int8


# ---------------------------------------------------------------------------
# Device decoders (torch, in the step)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _device_tables(device: torch.device) -> Dict[str, torch.Tensor]:
    """The decoders' constant tables on ``device``, copied once per device:
    a copy from pageable host memory in the step would make the host wait
    for all the work queued on the device."""

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return {
        "ycbcr_inv": dev(_YCBCR_INV.T),
        "quant": dev(DCT8_QUANT),
        "idct_m": dev(DCT8_IDCT_MATRIX),
    }


def decode(codec: str, payload: Dict[str, torch.Tensor], height: int, width: int) -> torch.Tensor:
    """Gathered payload (batch first) -> (B, H, W, 3) uint8 pixels, on the
    payload's device."""
    _check_codec(codec)
    if codec == "raw":
        return payload["raw"]
    if codec == "yuv420":
        return _decode_yuv420(payload, height, width)
    return _decode_dct8(payload, height, width)


def _decode_yuv420(payload, height: int, width: int) -> torch.Tensor:
    def up(p):
        p = p.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return p[:, :height, :width].to(torch.float32) - 128.0

    y = payload["y"].to(torch.float32)
    ycc = torch.stack([y, up(payload["cb"]), up(payload["cr"])], dim=-1)
    rgb = ycc @ _device_tables(y.device)["ycbcr_inv"]
    return torch.clamp(torch.round(rgb), 0, 255).to(torch.uint8)


def _decode_dct8(payload, height: int, width: int) -> torch.Tensor:
    from waternet_tpu_torch.ops.kernels import dct8_decode_u8

    coef = payload["coef"].contiguous()  # (B, nby, nbx, C, 16) int8
    tables = _device_tables(coef.device)
    return dct8_decode_u8(coef, tables["quant"], tables["idct_m"], height, width)


def roundtrip(codec: str, u8: np.ndarray, device="cuda") -> np.ndarray:
    """Host encode -> decode on ``device`` -> host uint8 (the bench's PSNR
    report). For ``raw`` this is the identity. ``device`` defaults to CUDA,
    as every entry point of the port, and raises without it; ``"cpu"``
    only when asked."""
    from waternet_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    u8 = np.asarray(u8, np.uint8)
    payload = {k: torch.from_numpy(v).to(device) for k, v in encode(codec, u8).items()}
    return decode(codec, payload, u8.shape[1], u8.shape[2]).cpu().numpy()


def psnr_db(a_u8: np.ndarray, b_u8: np.ndarray) -> float:
    """Peak signal-to-noise ratio between two uint8 arrays, in dB (``inf``
    for identical arrays)."""
    a = np.asarray(a_u8, np.float64)
    b = np.asarray(b_u8, np.float64)
    mse = float(np.mean((a - b) ** 2))
    if mse == 0.0:
        return float("inf")
    return 10.0 * np.log10(255.0**2 / mse)


# ---------------------------------------------------------------------------
# Preflight budgeter
# ---------------------------------------------------------------------------


def encoded_bytes_per_image(codec: str, height: int, width: int) -> int:
    """Encoded bytes of one (H, W, 3) image under ``codec``."""
    _check_codec(codec)
    if codec == "raw":
        return height * width * 3
    if codec == "yuv420":
        ch, cw = -(-height // 2), -(-width // 2)
        return height * width + 2 * ch * cw
    nby, nbx = -(-height // 8), -(-width // 8)
    return nby * nbx * 3 * DCT8_ZONE * DCT8_ZONE


def decode_flops_per_image(codec: str, height: int, width: int) -> int:
    """Approximate decode FLOPs per image (0 for raw)."""
    _check_codec(codec)
    if codec == "raw":
        return 0
    if codec == "yuv420":
        return height * width * 17  # 9 mul + 6 add, plus the chroma shift
    nby, nbx = -(-height // 8), -(-width // 8)
    z2 = DCT8_ZONE * DCT8_ZONE
    return nby * nbx * 3 * (z2 + 2 * z2 * 64)


def dihedral_variant_count(h: int, w: int) -> int:
    """Augmentations a precache table would hold per image: the 8 dihedral
    variants of a square image, the 4 of a non-square one."""
    return 8 if h == w else 4


def estimate_cache_bytes(
    codec: str,
    n_items: int,
    height: int,
    width: int,
    *,
    precache_histeq: bool = False,
    precache_vgg_ref: bool = False,
    vgg_ref_bytes_per_item: int = 0,
) -> int:
    """Resident bytes of an ``n_items``-pair cache under ``codec``: raw and
    ref, plus, for ``raw`` only, the precache tables (WB, GC and one CLAHE
    plane per dihedral variant; the VGG feature table when enabled), as
    the JAX package counts them."""
    total = n_items * 2 * encoded_bytes_per_image(codec, height, width)
    if codec == "raw" and precache_histeq:
        n_var = dihedral_variant_count(height, width)
        total += n_items * (2 + n_var) * height * width * 3
        if precache_vgg_ref:
            total += n_items * n_var * vgg_ref_bytes_per_item
    return total


def resolve_headroom(device=None) -> Optional[int]:
    """Bytes a cache may take on ``device``, or None when unknowable (CPU).

    ``WATERNET_CACHE_HEADROOM_BYTES`` overrides the live number. On CUDA:
    CUDA's free memory (``torch.cuda.mem_get_info``) plus what the
    caching allocator holds reserved but unallocated."""
    env = os.environ.get("WATERNET_CACHE_HEADROOM_BYTES")
    if env:
        return int(env)
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda":
        return None
    free, _total = torch.cuda.mem_get_info(dev)
    reserve = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    return int(free + reserve)


def budget_report(
    n_items: int,
    height: int,
    width: int,
    *,
    headroom: Optional[int],
    precache_histeq: bool = False,
    precache_vgg_ref: bool = False,
    vgg_ref_bytes_per_item: int = 0,
) -> List[dict]:
    """Per-codec rows, cheapest decode first. ``fits`` is None when the
    headroom is unknowable."""
    budget = None if headroom is None else int(headroom * HEADROOM_SAFETY)
    raw_pair = 2 * n_items * height * width * 3
    rows = []
    for codec in CODECS:
        nbytes = estimate_cache_bytes(
            codec, n_items, height, width,
            precache_histeq=precache_histeq,
            precache_vgg_ref=precache_vgg_ref,
            vgg_ref_bytes_per_item=vgg_ref_bytes_per_item,
        )
        rows.append({
            "codec": codec,
            "cache_bytes": nbytes,
            "compression_ratio": raw_pair
            / max(2 * n_items * encoded_bytes_per_image(codec, height, width), 1),
            "decode_flops_per_image": decode_flops_per_image(codec, height, width),
            "fits": None if budget is None else nbytes <= budget,
        })
    return rows


def choose_codec(
    requested: str,
    n_items: int,
    height: int,
    width: int,
    *,
    headroom: Optional[int],
    precache_histeq: bool = False,
    precache_vgg_ref: bool = False,
    vgg_ref_bytes_per_item: int = 0,
) -> dict:
    """Resolve ``requested`` (a codec or ``auto``) against the headroom and
    return the chosen codec's row. ``auto`` picks the first codec of the
    ladder that fits (raw when the headroom is unknowable); a named codec
    that does not fit, and an ``auto`` where nothing fits, raise
    :class:`CacheBudgetError`."""
    if requested != "auto" and requested not in CODECS:
        raise ValueError(
            f"unknown cache codec {requested!r} (choose from {CODECS + ('auto',)})"
        )
    rows = budget_report(
        n_items, height, width, headroom=headroom,
        precache_histeq=precache_histeq,
        precache_vgg_ref=precache_vgg_ref,
        vgg_ref_bytes_per_item=vgg_ref_bytes_per_item,
    )
    by_codec = {r["codec"]: r for r in rows}
    fitting = [r for r in rows if r["fits"]]
    if requested == "auto":
        if headroom is None:
            return by_codec["raw"]
        if fitting:
            return fitting[0]
        raise CacheBudgetError(
            f"no cache codec fits: {n_items} pairs at {height}x{width} need "
            + ", ".join(f"{r['codec']}={_fmt_bytes(r['cache_bytes'])}" for r in rows)
            + f" against {_fmt_bytes(headroom)} HBM headroom "
            f"(x{HEADROOM_SAFETY:g} safety) — shrink the dataset or "
            "image size, or train host-fed (drop --device-cache)"
        )
    row = by_codec[requested]
    if row["fits"] is False:
        hint = (
            f"; --cache-codec {fitting[0]['codec']} "
            f"({_fmt_bytes(fitting[0]['cache_bytes'])}) would fit"
            if fitting
            else "; no codec fits — shrink the dataset or image size"
        )
        raise CacheBudgetError(
            f"device cache codec {requested!r} does not fit: {n_items} pairs "
            f"at {height}x{width} need {_fmt_bytes(row['cache_bytes'])} "
            f"against {_fmt_bytes(headroom)} HBM headroom "
            f"(x{HEADROOM_SAFETY:g} safety){hint}"
        )
    return row


def _fmt_bytes(n: Optional[int]) -> str:
    if n is None:
        return "?"
    v = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(v) < 1024.0 or unit == "TiB":
            return f"{v:.1f} {unit}" if unit != "B" else f"{int(v)} B"
        v /= 1024.0
    return f"{int(n)} B"


def report_lines(rows: List[dict], headroom: Optional[int]) -> List[str]:
    """The ``--cache-report`` table, one string per line."""
    lines = [
        "device-cache budget (headroom: "
        + (_fmt_bytes(headroom) if headroom is not None else "unknown")
        + f", safety x{HEADROOM_SAFETY:g})",
        f"{'codec':<8} {'cache bytes':>12} {'ratio':>6} {'decode MFLOP/img':>16} {'fits':>5}",
    ]
    for r in rows:
        fits = "?" if r["fits"] is None else ("yes" if r["fits"] else "NO")
        lines.append(
            f"{r['codec']:<8} {_fmt_bytes(r['cache_bytes']):>12} "
            f"{r['compression_ratio']:>6.2f} "
            f"{r['decode_flops_per_image'] / 1e6:>16.2f} {fits:>5}"
        )
    return lines
