"""Header-only image metadata (no pixel decode).

The port's own copy of the JAX package's ``utils/imagemeta.py``: the
no-reference scorer (``python -m waternet_tpu_torch.score --raw-dir``)
groups files by shape, and a full ``cv2.imread`` per file would decode
every pixel just to read two ints.
"""

from __future__ import annotations

#: EXIF orientation values whose decode involves a 90-degree rotation
#: (transpose / rotate-90 variants): the decoded H and W swap vs the SOF
#: header. 1-4 are identity/flip (dimensions preserved); 0 and >8 are
#: out-of-spec and treated as identity, matching decoders.
_EXIF_TRANSPOSED = (5, 6, 7, 8)


def _exif_orientation(app1_payload: bytes) -> "int | None":
    """Orientation (tag 0x0112) from a JPEG APP1/Exif segment payload
    (the bytes after the segment length), or None when absent/garbled.
    Only IFD0 is walked — that is where orientation lives per EXIF 2.x.
    """
    if not app1_payload.startswith(b"Exif\x00\x00"):
        return None
    tiff = app1_payload[6:]
    if len(tiff) < 8:
        return None
    if tiff[:2] == b"II":
        endian = "little"
    elif tiff[:2] == b"MM":
        endian = "big"
    else:
        return None
    if int.from_bytes(tiff[2:4], endian) != 42:
        return None
    off = int.from_bytes(tiff[4:8], endian)
    if off + 2 > len(tiff):
        return None
    n_entries = int.from_bytes(tiff[off : off + 2], endian)
    for i in range(n_entries):
        e = off + 2 + 12 * i
        if e + 12 > len(tiff):
            return None
        if int.from_bytes(tiff[e : e + 2], endian) == 0x0112:
            # Type SHORT, count 1: the value sits in the first two bytes
            # of the 4-byte value field.
            return int.from_bytes(tiff[e + 8 : e + 10], endian)
    return None


def image_shape(path) -> "tuple[int, int, int] | None":
    """``(h, w, 3)`` of the image **as a decoder produces it** — from the
    file header alone, no pixel decode.

    Reads <=64 bytes for PNG/BMP and the marker chain for JPEG. Returns
    ``None`` when the header can't be parsed so the caller falls back to
    a full decode; channel count is pinned to 3 because ``cv2.imread``'s
    default flag decodes to 3-channel BGR regardless of the file's own
    channel count. For JPEGs the EXIF orientation tag is honored the way
    cv2 honors it at decode time: orientations 5-8 (90-degree rotations)
    swap the SOF header's H and W, so portrait phone photos report their
    decoded portrait shape — the scorer's shape grouping depends on
    header shapes matching decoded shapes, and additionally re-queues any
    residual header/decode disagreement under the decoded shape as a
    safety net.
    """
    try:
        with open(path, "rb") as fh:
            head = fh.read(32)
            if head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR":
                w = int.from_bytes(head[16:20], "big")
                h = int.from_bytes(head[20:24], "big")
                return (h, w, 3) if h > 0 and w > 0 else None
            if head[:2] == b"BM" and len(head) >= 26:
                # BITMAPINFOHEADER: int32 width/height at 18/22; height<0
                # means top-down row order, same pixel dimensions.
                w = int.from_bytes(head[18:22], "little", signed=True)
                h = int.from_bytes(head[22:26], "little", signed=True)
                return (abs(h), abs(w), 3) if h != 0 and w > 0 else None
            if head[:2] == b"\xff\xd8":  # JPEG: walk markers to SOFn
                fh.seek(2)
                orientation = None
                while True:
                    b = fh.read(1)
                    if not b:
                        return None
                    if b != b"\xff":
                        continue
                    marker = fh.read(1)
                    while marker == b"\xff":  # legal fill bytes
                        marker = fh.read(1)
                    if not marker:
                        return None
                    m = marker[0]
                    # Standalone markers (no length field): TEM, RSTn, SOI.
                    if m == 0x01 or 0xD0 <= m <= 0xD8:
                        continue
                    if m == 0xD9:  # EOI before any SOF
                        return None
                    if m == 0xDA:
                        # SOS before any SOF: what follows is
                        # entropy-coded data where 0xFF bytes are
                        # stuffing/restart markers, not a marker chain —
                        # walking on can "find" a fake SOF and return a
                        # garbage shape. Give up; the caller falls back
                        # to a full decode.
                        return None
                    seg = fh.read(2)
                    if len(seg) < 2:
                        return None
                    seglen = int.from_bytes(seg, "big")
                    if seglen < 2:
                        return None
                    # SOF0..SOF15 carry the frame size; C4/C8/CC are
                    # DHT/JPG/DAC, not frame headers.
                    if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
                        sof = fh.read(5)
                        if len(sof) < 5:
                            return None
                        h = int.from_bytes(sof[1:3], "big")
                        w = int.from_bytes(sof[3:5], "big")
                        if h <= 0 or w <= 0:
                            return None
                        if orientation in _EXIF_TRANSPOSED:
                            h, w = w, h  # decoder rotates 90 degrees
                        return (h, w, 3)
                    if m == 0xE1 and orientation is None:
                        # APP1: may carry the Exif orientation that cv2
                        # applies at decode time — read it so the shape
                        # we report is the shape a decode produces.
                        orientation = _exif_orientation(fh.read(seglen - 2))
                        continue
                    fh.seek(seglen - 2, 1)
    except OSError:
        return None
    return None
