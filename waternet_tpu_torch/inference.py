"""Image / directory / video inference CLI of the port.

    python -m waternet_tpu_torch.inference --source img_dir_or_video \\
        --weights tests/fixtures/distill/teacher.npz [--device-preprocess] \\
        [--precision bf16] [--show-split] [--workers N]

    python -m waternet_tpu_torch.inference --source img_dir \\
        --serve-url http://127.0.0.1:8080     # thin client of a server

    python -m waternet_tpu_torch.inference --source img_dir --tier fast \\
        --student-weights tests/fixtures/distill/student.npz [--quantize]

Outputs land in ``<output-root>/<name or next number>/`` under the source
file names (a video as ``<stem>.mp4``), as the JAX package's
``inference.py`` writes them. A directory of images goes through the
shape-bucketed serving engine by default (``waternet_tpu_torch/
serving/``, docs/SERVING.md): every image pads up to the smallest bucket
of a ladder derived from a header-only scan (``--serve-buckets``,
``--max-buckets``), batches of ``--batch-size`` slots coalesce within
``--max-wait-ms``, the replica pool (``--serve-replicas``) runs them, the
outputs are cropped back and written in path order, and the run ends
with a ``{"serving_stats": {...}}`` line. ``--exact-shapes`` (and a
single-file source) stacks consecutive same-shaped images into batches
of up to ``--batch-size`` instead, a shape change flushing the batch.
``--workers`` threads decode ahead of the device, in path order.
``--serve-url`` posts each image file to a running server
(``python -m waternet_tpu_torch.serving.server``) and writes the answers
in the same layout; it builds no engine. Videos (mp4, mpeg, avi): ``--batch-size`` frames a
device batch, the tail padded, decoded on a background thread unless
``--workers 0``; the run ends with a ``{"video_ingest": {...}}`` line.
``--show-split`` writes the left half of the original beside the right
half of the output, labelled. ``--quantize`` runs static int8
(``models/quant.py``), calibrated on the source's first images or frames.
``--tier fast`` serves the distilled CAN student (``--student-weights``;
raw RGB in, no WB/GC/CLAHE); with ``--serve-url`` the tier travels as
``X-Tier``, and ``--allow-downgrade`` opts into the server's brown-out
downgrades, each reported at the end. ``--spatial-shards N`` splits each
image's height over N cards (the exact halo scheme of
``parallel/spatial.py``) and ``--data-shards N`` each batch over N cards;
either needs N visible cards and exits non-zero naming the count
otherwise (the CPU runs N shards on itself). ``--download`` is accepted
for the JAX CLI's sake and exits 2: the port fetches nothing over the
network. Runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

IM_SUFFIXES = [".bmp", ".jpg", ".jpeg", ".png", ".gif"]
VID_SUFFIXES = [".mp4", ".mpeg", ".avi"]
_REPO_ROOT = Path(__file__).resolve().parent.parent


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument(
        "--source", required=True,
        help="Input image, video or directory. Images: bmp, jpg, jpeg, png, gif; videos: mp4, mpeg, avi.",
    )
    p.add_argument(
        "--weights",
        help="Model weights: .npz (JAX format) or the reference's .pt. "
        "Defaults to local weight resolution.",
    )
    p.add_argument("--name", help="Subfolder name under the output root.")
    p.add_argument(
        "--download", action="store_true",
        help="The JAX CLI's fetch of the reference's checkpoint: accepted, and exits 2 (the port "
        "fetches nothing over the network; place the weights locally).",
    )
    p.add_argument(
        "--show-split", action="store_true",
        help="Left/right of the output is original/processed, with before/after labels.",
    )
    p.add_argument(
        "--batch-size", type=int, default=4,
        help="Frames of a video, or most same-shaped consecutive images, per device batch.",
    )
    p.add_argument(
        "--device-preprocess", action="store_true",
        help="Run WB/GC/CLAHE on the device instead of the host.",
    )
    p.add_argument(
        "--workers", type=int, default=2,
        help="Decode threads: directories decode images ahead of the device; videos decode "
        "batches on a background thread. 0 = synchronous.",
    )
    p.add_argument(
        "--precision", default="fp32", choices=["fp32", "bf16"],
        help="The model's compute precision (bf16: autocast over fp32 parameters).",
    )
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'.")
    p.add_argument(
        "--spatial-shards", type=int, default=1,
        help="Split each image's height over N devices with exact halo exchange (for frames too "
        "large for one card).",
    )
    p.add_argument(
        "--data-shards", type=int, default=1,
        help="Shard each frame batch over N devices (video throughput scale-out; batches pad to a "
        "multiple of N, so use a --batch-size that is a multiple of N for full utilization).",
    )
    p.add_argument(
        "--exact-shapes", action="store_true",
        help="Directory sources: per-shape batching (consecutive same-shaped images) "
        "instead of the bucketed serving engine.",
    )
    p.add_argument(
        "--serve-buckets", default="auto",
        help="Bucket ladder for directory sources: 'auto' (derived from a header-only "
        "shape scan of the directory) or a comma list like '256,512,1080x1920' (bare N = "
        "NxN). Pixels beyond the 13 px receptive radius from the pad seam are computed "
        "from the same values as the native forward's (docs/SERVING.md).",
    )
    p.add_argument(
        "--max-buckets", type=int, default=3,
        help="Ladder size cap for --serve-buckets auto: more buckets, less padding.",
    )
    p.add_argument(
        "--max-wait-ms", type=float, default=20.0,
        help="Bucketed serving: flush a partial batch once its oldest image has waited "
        "this long.",
    )
    p.add_argument(
        "--serve-replicas", default="auto",
        help="Bucketed serving: replica-pool size, 'auto' (every CUDA card; 1 on the "
        "CPU) or N. Outputs are byte-identical at any replica count.",
    )
    p.add_argument(
        "--serve-url",
        help="Thin client: POST each image to this server's /enhance "
        "(python -m waternet_tpu_torch.serving.server) and write the answers; no "
        "weights, no engine.",
    )
    p.add_argument(
        "--quantize", action="store_true",
        help="Static int8 inference (exact int8 convolutions, models/quant.py), calibrated on the "
        "source's first images or frames.",
    )
    p.add_argument(
        "--tier", default="quality", choices=["quality", "fast"],
        help="Serving tier: 'quality' (default), the full WaterNet pipeline; 'fast', the "
        "distilled CAN student (raw RGB in, no WB/GC/CLAHE, ~1/34 the teacher's FLOPs; needs "
        "--student-weights locally, or a --serve-url server started with one).",
    )
    p.add_argument("--student-weights", help="CAN student checkpoint for --tier fast (a train --distill product).")
    p.add_argument(
        "--allow-downgrade", action="store_true",
        help="--serve-url only: opt into brown-out downgrades (X-Tier-Allow-Downgrade: 1): a "
        "saturated server may serve quality requests from the fast tier instead of shedding "
        "them; every downgrade is reported at the end.",
    )
    p.add_argument(
        "--output-root", default=str(_REPO_ROOT / "output"),
        help="Base directory of the numbered run directories.",
    )
    args = p.parse_args(argv)
    if args.batch_size < 1:
        p.error("--batch-size must be >= 1")
    if args.workers < 0:
        p.error("--workers must be >= 0")
    if args.max_buckets < 1:
        p.error("--max-buckets must be >= 1")
    if args.allow_downgrade and not args.serve_url:
        # Brown-out is the SERVER's saturation response: local serving has
        # none, and ignoring the opt-in silently would mislead.
        p.error("--allow-downgrade is a --serve-url (thin-client) option: brown-out downgrades are "
                "the server's saturation response")
    if args.download:
        p.error("--download fetches the reference's checkpoint over the network, which the port does "
                "not do: pass --weights, set WATERNET_TPU_WEIGHTS or place the checkpoint in ./weights")
    if args.spatial_shards < 1 or args.data_shards < 1:
        p.error("--spatial-shards and --data-shards must be >= 1")
    if args.tier == "fast" and (args.device_preprocess or args.spatial_shards > 1 or args.data_shards > 1):
        p.error("--tier fast is incompatible with --device-preprocess/--spatial-shards/--data-shards: "
                "the student has no preprocessing to move and fits on one card by design")
    return args


def calibration_from_sources(files, limit: int = 4):
    """(x, wb, he, gc) float batches from the user's own inputs, for the
    int8 activation scales (``models/quant.py``): images directly, a
    video's first ``limit`` frames. None if nothing is readable (the
    synthetic defaults then)."""
    from waternet_tpu_torch.ops.transform import transform_np

    def as_batch(rgb):
        wb, gc, he = transform_np(rgb)
        return tuple(a[None].astype(np.float32) / 255.0 for a in (rgb, wb, he, gc))

    return [as_batch(rgb) for rgb in _calibration_frames(files, limit)] or None


def raw_calibration_from_sources(files, limit: int = 4):
    """Raw-frame [0, 1] calibration batches for the int8 student
    (``quantize_can``): decode only, the student consumes no variants."""
    return [rgb[None].astype(np.float32) / 255.0 for rgb in _calibration_frames(files, limit)] or None


def _calibration_frames(files, limit: int):
    import cv2

    frames = []
    for f in files:
        if len(frames) >= limit:
            break
        if f.suffix.lower() in IM_SUFFIXES:
            im = cv2.imread(str(f))
            if im is not None:
                frames.append(cv2.cvtColor(im, cv2.COLOR_BGR2RGB))
        elif f.suffix.lower() in VID_SUFFIXES:
            cap = cv2.VideoCapture(str(f))
            while len(frames) < limit:
                ok, frame = cap.read()
                if not ok:
                    break
                frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            cap.release()
    return frames


def annotate_split(composite, width_split, label_before="Before", label_after="After"):
    """Burn before/after labels onto a split composite (BGR, in place)."""
    import cv2

    for text, org in ((label_before, (50, 50)), (label_after, (width_split + 50, 50))):
        cv2.putText(
            img=composite,
            text=text,
            org=org,
            fontFace=cv2.FONT_HERSHEY_DUPLEX,
            fontScale=1,
            color=(255, 255, 255),
            thickness=2,
        )


def make_split(bgr_before, bgr_after):
    """The left half of ``bgr_before`` beside the right half of
    ``bgr_after``, labelled."""
    composite = np.zeros_like(bgr_after)
    w = bgr_after.shape[1] // 2
    composite[:, :w] = bgr_before[:, :w]
    composite[:, w:] = bgr_after[:, w:]
    annotate_split(composite, w)
    return composite


def _decode_for(path):
    """path -> (path, bgr, rgb), or (path, None, None) if unreadable."""
    import cv2

    bgr = cv2.imread(str(path))
    if bgr is None:
        return path, None, None
    return path, bgr, cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def _write_output(savedir: Path, path: Path, bgr, out_rgb, show_split: bool):
    import cv2

    out_bgr = cv2.cvtColor(out_rgb, cv2.COLOR_RGB2BGR)
    out = make_split(bgr, out_bgr) if show_split else out_bgr
    savedir.mkdir(parents=True, exist_ok=True)
    cv2.imwrite(str(savedir / path.name), out)


def run_images(engine, paths, savedir: Path, show_split: bool, batch_size: int, workers: int = 2) -> int:
    """Enhance ``paths`` in same-shape batches of up to ``batch_size``
    (:class:`~waternet_tpu_torch.serving.batcher.ExactShapeBatcher`), in
    path order; ``workers`` threads decode ahead (0: inline). Returns the
    images written."""
    from waternet_tpu_torch.data.pipeline import OrderedPipeline
    from waternet_tpu_torch.serving.batcher import ExactShapeBatcher

    batcher = ExactShapeBatcher(engine, batch_size)
    written = 0

    def write_all(results):
        nonlocal written
        for (path, bgr), out_rgb in results:
            _write_output(savedir, path, bgr, out_rgb, show_split)
            written += 1

    with OrderedPipeline(_decode_for, paths, workers=workers, name="decode") as pipe:
        for path, bgr, rgb in pipe:
            if bgr is None:
                print(f"Skipping unreadable image: {path}", file=sys.stderr)
                continue
            write_all(batcher.push((path, bgr), rgb))
    write_all(batcher.flush())
    return written


def run_images_bucketed(
    engine, paths, savedir: Path, show_split: bool, batch_size: int, workers: int = 2,
    buckets: str = "auto", max_wait_ms: float = 20.0, max_buckets: int = 3, replicas="auto",
    tier: str = "quality",
):
    """Enhance a directory through the shape-bucketed serving engine: every
    image pads up to its bucket and the output crops back, so the stream
    is served by at most ``len(buckets)`` warmed batch shapes per replica.
    Outputs are written in path order (byte-identical at any replica
    count) and the run ends with the serving stats JSON line; returns the
    stats."""
    from collections import deque

    from waternet_tpu_torch.data.pipeline import OrderedPipeline
    from waternet_tpu_torch.serving import DynamicBatcher, resolve_ladder, scan_shapes

    spec = buckets.strip().lower()
    ladder = resolve_ladder(
        buckets, shapes=scan_shapes(paths) if spec == "auto" else None, max_buckets=max_buckets,
    )
    # The stats name the tier actually served (--tier fast runs the
    # student as the primary engine).
    batcher = DynamicBatcher(engine, ladder, max_batch=batch_size, max_wait_ms=max_wait_ms,
                             replicas=replicas, tier_name=tier)
    print(
        f"Serving buckets: {', '.join(batcher.ladder.describe())} "
        f"(batch {batcher.max_batch}, replicas {batcher.n_replicas})"
    )
    window: deque = deque()  # (path, bgr, future), path order

    def write_head():
        path, bgr, fut = window.popleft()
        _write_output(savedir, path, bgr, fut.result(), show_split)

    try:
        with OrderedPipeline(_decode_for, paths, workers=workers, name="decode") as pipe:
            for path, bgr, rgb in pipe:
                if bgr is None:
                    print(f"Skipping unreadable image: {path}", file=sys.stderr)
                    continue
                window.append((path, bgr, batcher.submit(rgb)))
                while window and window[0][2].done():
                    write_head()
                # Backpressure: a few batches of decoded images and pending
                # results per replica, never the whole directory.
                while len(window) >= 4 * batcher.max_batch * batcher.n_replicas:
                    write_head()
        batcher.drain()
        while window:
            write_head()
    finally:
        batcher.close()
    print(batcher.stats.to_json())
    return batcher.stats


def run_images_remote(
    url: str, paths, savedir: Path, show_split: bool, max_retries: int = 10,
    tier: str = "quality", allow_downgrade: bool = False,
) -> int:
    """Thin client of the HTTP front door: POST each image file's bytes to
    ``<url>/enhance`` and write the answers in local serving's layout.

    The server decodes the bytes as the local path decodes the file
    (``cv2.imdecode`` == ``cv2.imread``) and runs the same bucketed pool,
    and PNG is lossless, so the files are byte for byte what a local run
    with the server's configuration writes. A 429 (shedding) is retried
    after ``Retry-After``, up to ``max_retries`` times; any other non-200
    aborts loudly. ``tier`` travels as ``X-Tier`` (checked here too: an
    unknown name never reaches the server); ``allow_downgrade`` sets
    ``X-Tier-Allow-Downgrade: 1``, and answers served by another tier
    (``X-Tier-Served``) are counted and reported at the end. Returns the
    images written."""
    import http.client
    import time
    from urllib.parse import urlparse

    import cv2

    tier = str(tier).lower()
    if tier not in ("quality", "fast"):
        raise SystemExit(f"unknown tier {tier!r}: valid tiers are 'quality' and 'fast'")
    headers = {"Content-Type": "application/octet-stream", "X-Tier": tier}
    if allow_downgrade:
        headers["X-Tier-Allow-Downgrade"] = "1"
    downgraded = 0
    u = urlparse(url)
    conn = http.client.HTTPConnection(u.hostname, u.port or 80, timeout=300)
    written = 0
    try:
        for path in paths:
            bgr = cv2.imread(str(path))
            if bgr is None:
                print(f"Skipping unreadable image: {path}", file=sys.stderr)
                continue
            data = path.read_bytes()
            for _ in range(max_retries + 1):
                conn.request("POST", "/enhance", body=data, headers=headers)
                resp = conn.getresponse()
                body = resp.read()
                if resp.status != 429:
                    break
                time.sleep(min(float(resp.getheader("Retry-After", "1")), 5.0))
            if resp.status != 200:
                raise SystemExit(f"server returned {resp.status} for {path.name}: {body[:200]!r}")
            if resp.getheader("X-Tier-Served", tier) != tier:
                downgraded += 1
            out_bgr = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
            out = make_split(bgr, out_bgr) if show_split else out_bgr
            savedir.mkdir(parents=True, exist_ok=True)
            cv2.imwrite(str(savedir / path.name), out)
            written += 1
    finally:
        conn.close()
    if downgraded:
        print(f"{downgraded} request(s) served by the fast tier under brown-out (X-Tier-Served)")
    return written


def run_video(engine, path: Path, savedir: Path, show_split: bool, batch_size: int, workers: int = 2) -> dict:
    """Enhance one video into ``savedir/<stem>.mp4`` (avc1, else mp4v; no
    encoder raises) and print the ``video_ingest`` line; returns it."""
    import cv2

    from waternet_tpu_torch.data.video import enhance_video_stream

    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        raise RuntimeError(f"could not open video {path}")
    fps = int(cap.get(cv2.CAP_PROP_FPS))
    fw = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    fh = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    print(f"Working on {path.name}: {fw}x{fh}, {total} frames")

    savedir.mkdir(parents=True, exist_ok=True)
    outpath = str(savedir / (path.stem + ".mp4"))
    # avc1 first, as the reference writes; not every ffmpeg build ships an
    # h264 encoder, so fall back to mp4v rather than write an empty file.
    writer = cv2.VideoWriter(outpath, cv2.VideoWriter.fourcc(*"avc1"), fps, (fw, fh))
    if not writer.isOpened():
        print("avc1 encoder unavailable; falling back to mp4v")
        writer = cv2.VideoWriter(outpath, cv2.VideoWriter.fourcc(*"mp4v"), fps, (fw, fh))
    if not writer.isOpened():
        cap.release()
        raise RuntimeError(f"could not open any mp4 encoder for {outpath}")

    n = 0
    ingest: dict = {}
    try:
        stream = enhance_video_stream(
            engine, cap, batch_size=batch_size, stats=ingest, prefetch=2 if workers > 0 else 0,
        )
        for bgr_in, bgr_out in stream:
            writer.write(make_split(bgr_in, bgr_out) if show_split else bgr_out)
            n += 1
            if n % 50 == 0:
                print(f"Processed {n} frames")
    finally:
        cap.release()
        writer.release()
    decoded = int(ingest.get("frames_decoded", 0))
    failures = int(ingest.get("decode_failures", 0))
    line = {
        "video_ingest": {
            "frames_decoded": decoded,
            "decode_failures_mid_stream": failures,
            "frames_skipped": failures,
            "frames_written": n,
            "declared_frame_count": total,
            # Declared but never reached (container metadata against the
            # stream's real end); a negative declaration clamps to 0.
            "missing_at_eof": max(0, total - decoded - failures),
        }
    }
    print(json.dumps(line))
    return line


def main(argv=None):
    args = parse_args(argv)
    from waternet_tpu_torch.utils.rundir import next_run_dir

    source = Path(args.source)
    if not source.exists():
        raise SystemExit(f"{args.source} does not exist")
    if source.is_dir():
        files = sorted(
            p for p in source.glob("*")
            if p.suffix.lower() in IM_SUFFIXES + VID_SUFFIXES
        )
    else:
        files = [source]
    print(f"Total images/videos: {len(files)}")
    images = [f for f in files if f.suffix.lower() in IM_SUFFIXES]
    if args.serve_url:
        # Thin client: the running server owns the model.
        if len(images) != len(files):
            raise SystemExit(
                "--serve-url serves image sources only (the front door is a "
                "request/response gateway; enhance videos locally)"
            )
        savedir = next_run_dir(Path(args.output_root), args.name)
        n = run_images_remote(args.serve_url, images, savedir, args.show_split,
                              tier=args.tier, allow_downgrade=args.allow_downgrade)
        print(f"Saved {n} images to {savedir}")
        return

    import torch

    from waternet_tpu_torch.inference_engine import InferenceEngine, StudentEngine

    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    if args.tier == "fast":
        # The distilled CAN student: raw RGB in, no WB/GC/CLAHE anywhere;
        # calibrated (with --quantize) on raw frames only.
        engine = StudentEngine(
            weights=args.student_weights, dtype=dtype, quantize=args.quantize, device=args.device,
            calib_batches=raw_calibration_from_sources(files) if args.quantize else None,
        )
    else:
        try:
            engine = InferenceEngine(
                weights=args.weights,
                device_preprocess=args.device_preprocess,
                device=args.device,
                dtype=dtype,
                quantize=args.quantize,
                # Calibrate on the ACTUAL inputs so their activations are not clipped.
                calib_batches=calibration_from_sources(files) if args.quantize else None,
                spatial_shards=args.spatial_shards,
                data_shards=args.data_shards,
            )
        except ValueError as e:
            if not (args.spatial_shards > 1 or args.data_shards > 1):
                raise
            raise SystemExit(f"--spatial-shards {args.spatial_shards} --data-shards {args.data_shards}: {e}")
    savedir = next_run_dir(Path(args.output_root), args.name)
    if images:
        if source.is_dir() and not args.exact_shapes:
            stats = run_images_bucketed(
                engine, images, savedir, args.show_split, args.batch_size, args.workers,
                buckets=args.serve_buckets, max_wait_ms=args.max_wait_ms,
                max_buckets=args.max_buckets, replicas=args.serve_replicas, tier=args.tier,
            )
            n = stats.requests
        else:
            n = run_images(engine, images, savedir, args.show_split, args.batch_size, args.workers)
        print(f"Saved {n} images to {savedir}")
    for f in files:
        if f.suffix.lower() in VID_SUFFIXES:
            run_video(engine, f, savedir, args.show_split, args.batch_size, args.workers)
    print(f"Saved output to {savedir}")


if __name__ == "__main__":
    main()
