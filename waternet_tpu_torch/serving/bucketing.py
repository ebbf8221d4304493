"""Shape bucketing: serve arbitrary-resolution streams with a fixed,
small set of warmed batch shapes.

The JAX package's ``serving/bucketing.py``, lifted (it imports nothing
of JAX), with the receptive radius taken from the port's own model.

A per-shape batcher flushes its pending batch on every shape change, and
each new resolution meets the device cold (in the port: cuDNN's plan and
the caching allocator's blocks for that shape; in the JAX package: an XLA
compile). On a mixed-resolution stream (UIEB challenge-60, any
user-upload workload) that degrades to fragment batches with cold starts
on the critical path. The fix is a small ladder of *buckets*: every input
is padded up to the smallest bucket that covers it, the whole stream is
served by at most ``len(buckets)`` batch shapes, and the output is cropped
back to the native shape.

Exactness policy (docs/SERVING.md; pinned in tests/test_torch_serving.py):
padding is applied on the bottom/right edges only, so the original image
occupies the top-left corner of the padded canvas and its top/left
borders see the exact same SAME-conv zero padding as the native forward.
WaterNet's receptive-field radius is :data:`RECEPTIVE_RADIUS` = 13
pixels (the confidence-map generator's 7/5/3/1/7/5/3/3 convolutions). A
pixel farther than that from the pad seam has a receptive field that
lies entirely inside original content, so its output is computed from
the same values as the native-shape forward's; only the bottom/right
seam band of width 13 can differ, and there the reflect-pad content keeps
the error PSNR-bounded rather than the hard discontinuity zero-padding
would give.

Inputs are reflect-padded (mirror without repeating the seam row) when
the pad fits in one reflection, falling back to edge-replication for
pads wider than the image — the interior exactness argument does not
depend on what the pad contains.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from waternet_tpu_torch.models.waternet import _CMG_SPEC

#: WaterNet's receptive-field radius in pixels: the confidence-map
#: generator's convolutions (kernels 7/5/3/1/7/5/3 and its final 3x3; the
#: port's ``_CMG_SPEC`` lists all eight). The refiner branches' radius
#: (7/5/3 -> 6) is strictly smaller, so the fused output's radius is the
#: generator's. Equals the JAX package's (tested).
RECEPTIVE_RADIUS = sum((k - 1) // 2 for _, _, k in _CMG_SPEC)

Bucket = Tuple[int, int]  # (height, width)


class BucketLadder:
    """An ordered ladder of (H, W) compile buckets.

    :meth:`bucket_for` maps a native shape to the *smallest-area* bucket
    that covers it in both dimensions, or ``None`` when the shape
    overflows every bucket (the caller falls back to a native-shape
    forward and counts it).
    """

    def __init__(self, buckets: Iterable[Bucket]):
        seen = sorted({(int(h), int(w)) for h, w in buckets})
        if not seen:
            raise ValueError("bucket ladder needs at least one (H, W) bucket")
        for h, w in seen:
            if h <= 0 or w <= 0:
                raise ValueError(f"bucket {h}x{w} is not a valid shape")
        # Smallest-area-first so bucket_for's first hit is the cheapest.
        self.buckets: List[Bucket] = sorted(seen, key=lambda b: (b[0] * b[1], b))

    def bucket_for(self, h: int, w: int) -> Optional[Bucket]:
        for bh, bw in self.buckets:
            if bh >= h and bw >= w:
                return (bh, bw)
        return None

    def __len__(self) -> int:
        return len(self.buckets)

    def __iter__(self):
        return iter(self.buckets)

    def __repr__(self) -> str:
        return "BucketLadder(%s)" % ", ".join(f"{h}x{w}" for h, w in self.buckets)

    def describe(self) -> List[str]:
        return [f"{h}x{w}" for h, w in self.buckets]


def parse_buckets(spec: str) -> BucketLadder:
    """``"256,512,1080x1920"`` -> ladder of (256,256), (512,512),
    (1080,1920). A bare integer is a square bucket; ``HxW`` is explicit."""
    buckets = []
    for tok in spec.split(","):
        tok = tok.strip().lower()
        if not tok:
            continue
        try:
            if "x" in tok:
                h, w = tok.split("x")
                buckets.append((int(h), int(w)))
            else:
                buckets.append((int(tok), int(tok)))
        except ValueError:
            raise ValueError(
                f"bad bucket {tok!r} in {spec!r}: use N (square) or HxW"
            ) from None
    return BucketLadder(buckets)


def derive_buckets(
    shapes: Sequence[Tuple[int, int]], max_buckets: int = 3
) -> BucketLadder:
    """Auto-derive a ladder of at most ``max_buckets`` buckets from the
    native shapes of a scanned directory, minimizing total padded pixels.

    Shapes are sorted by height and partitioned into contiguous groups;
    each group's bucket is its elementwise (max H, max W), which always
    covers every member. The partition minimizing total padded area is
    found by O(n^2 * k) dynamic programming — a directory scan is a few
    hundred shapes, so exact beats clever here.
    """
    uniq = sorted({(int(h), int(w)) for h, w in shapes})
    if not uniq:
        raise ValueError("derive_buckets needs at least one shape")
    k = min(max_buckets, len(uniq))
    n = len(uniq)

    # cost(i, j): padded area of covering uniq[i..j] with one bucket
    # (max H over the slice is uniq[j][0] since sorted by H; W needs a
    # max). A prefix sum of native areas keeps each evaluation O(1), so
    # the DP stays O(n^2 k) as claimed.
    maxw_from = [[0] * n for _ in range(n)]
    for i in range(n):
        mw = 0
        for j in range(i, n):
            mw = max(mw, uniq[j][1])
            maxw_from[i][j] = mw
    area_pref = [0] * (n + 1)
    for i, (h, w) in enumerate(uniq):
        area_pref[i + 1] = area_pref[i] + h * w

    def cost(i: int, j: int) -> int:
        bh, bw = uniq[j][0], maxw_from[i][j]
        return (j - i + 1) * bh * bw - (area_pref[j + 1] - area_pref[i])

    INF = float("inf")
    best = [[INF] * (k + 1) for _ in range(n + 1)]
    back = [[0] * (k + 1) for _ in range(n + 1)]
    best[0][0] = 0
    for j in range(1, n + 1):
        for g in range(1, k + 1):
            for i in range(j):
                if best[i][g - 1] == INF:
                    continue
                c = best[i][g - 1] + cost(i, j - 1)
                if c < best[j][g]:
                    best[j][g] = c
                    back[j][g] = i
    g = min(range(1, k + 1), key=lambda gg: best[n][gg])
    cuts = []
    j = n
    while g:
        i = back[j][g]
        cuts.append((i, j))
        j, g = i, g - 1
    buckets = [
        (uniq[j - 1][0], maxw_from[i][j - 1]) for i, j in reversed(cuts)
    ]
    return BucketLadder(buckets)


def scan_shapes(
    paths: Iterable[Path], decode_budget: int = 16
) -> List[Tuple[int, int]]:
    """Native (H, W) of each readable image, header-only where possible.

    Uses the shared container-header parser
    (:func:`waternet_tpu_torch.utils.imagemeta.image_shape` — the same pass-1
    trick score.py's no-reference path uses). Containers it can't parse
    (e.g. GIF) fall back to a full ``cv2.imread`` decode, but only for
    the first ``decode_budget`` such files: the ladder only needs a
    shape *sample*, and decoding an entire unparseable directory twice
    per run (once here, once in the serving pipeline) is exactly the
    cost the header-only scan exists to avoid. Unreadable files are
    skipped; the batcher skips them again at decode time.
    """
    from waternet_tpu_torch.utils.imagemeta import image_shape

    shapes = []
    for p in paths:
        shape = image_shape(p)
        if shape is None and decode_budget > 0:
            import cv2

            decode_budget -= 1
            im = cv2.imread(str(p))
            shape = None if im is None else im.shape
        if shape is not None:
            shapes.append((int(shape[0]), int(shape[1])))
    return shapes


def pad_to_bucket(img: np.ndarray, bh: int, bw: int) -> np.ndarray:
    """Pad an (H, W, C) array to (bh, bw, C) on the bottom/right edges.

    Reflect (mirror, seam row not repeated) keeps the seam band smooth;
    np.pad's reflect cannot exceed ``dim - 1``, so wider pads fall back to
    edge replication per axis. Top/left are never padded — the exactness
    policy requires the original content to keep its top-left corner.
    """
    h, w = img.shape[:2]
    if bh < h or bw < w:
        raise ValueError(f"image {h}x{w} does not fit bucket {bh}x{bw}")
    if bh == h and bw == w:
        return img
    out = img
    pad_h, pad_w = bh - h, bw - w
    if pad_h:
        mode = "reflect" if pad_h <= h - 1 else "edge"
        out = np.pad(out, ((0, pad_h), (0, 0), (0, 0)), mode=mode)
    if pad_w:
        mode = "reflect" if pad_w <= w - 1 else "edge"
        out = np.pad(out, ((0, 0), (0, pad_w), (0, 0)), mode=mode)
    return out


def padding_overhead(
    shapes: Sequence[Tuple[int, int]], ladder: BucketLadder
) -> float:
    """Fraction of padded-canvas pixels that are padding, over a shape
    population served by ``ladder`` (oversize shapes serve at native
    resolution and contribute zero padding)."""
    real = padded = 0
    for h, w in shapes:
        b = ladder.bucket_for(h, w)
        bh, bw = b if b is not None else (h, w)
        real += h * w
        padded += bh * bw
    return 0.0 if padded == 0 else 1.0 - real / padded
