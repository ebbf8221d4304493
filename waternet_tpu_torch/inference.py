"""Image / directory / video inference CLI of the port.

    python -m waternet_tpu_torch.inference --source img_dir_or_video \\
        --weights tests/fixtures/distill/teacher.npz [--device-preprocess] \\
        [--precision bf16] [--show-split] [--workers N]

Outputs land in ``<output-root>/<name or next number>/`` under the source
file names (a video as ``<stem>.mp4``), as the JAX package's
``inference.py`` writes them. Images: consecutive same-shaped images are
stacked into batches of up to ``--batch-size``, a shape change flushes
the batch (the JAX CLI's ``--exact-shapes`` path); ``--workers`` threads
decode ahead of the device, in path order, with the same batches as
``--workers 0``. Videos (mp4, mpeg, avi): ``--batch-size`` frames a
device batch, the tail padded, decoded on a background thread unless
``--workers 0``; the run ends with a ``{"video_ingest": {...}}`` line.
``--show-split`` writes the left half of the original beside the right
half of the output, labelled. Runs on CUDA unless ``--device cpu``.
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
        "--output-root", default=str(_REPO_ROOT / "output"),
        help="Base directory of the numbered run directories.",
    )
    args = p.parse_args(argv)
    if args.batch_size < 1:
        p.error("--batch-size must be >= 1")
    if args.workers < 0:
        p.error("--workers must be >= 0")
    return args


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
    """Enhance ``paths`` in same-shape batches of up to ``batch_size``, in
    path order; ``workers`` threads decode ahead (0: inline). Returns the
    images written."""
    from waternet_tpu_torch.data.pipeline import OrderedPipeline

    pending = []
    written = 0

    def flush():
        nonlocal written
        out = engine.enhance(np.stack([rgb for _, _, rgb in pending]))
        for (path, bgr, _), out_rgb in zip(pending, out):
            _write_output(savedir, path, bgr, out_rgb, show_split)
        written += len(pending)
        pending.clear()

    with OrderedPipeline(_decode_for, paths, workers=workers, name="decode") as pipe:
        for path, bgr, rgb in pipe:
            if bgr is None:
                print(f"Skipping unreadable image: {path}", file=sys.stderr)
                continue
            if pending and rgb.shape != pending[0][2].shape:
                flush()
            pending.append((path, bgr, rgb))
            if len(pending) == batch_size:
                flush()
    if pending:
        flush()
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
    import torch

    from waternet_tpu_torch.inference_engine import InferenceEngine
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
    engine = InferenceEngine(
        weights=args.weights,
        device_preprocess=args.device_preprocess,
        device=args.device,
        dtype=torch.bfloat16 if args.precision == "bf16" else torch.float32,
    )
    savedir = next_run_dir(Path(args.output_root), args.name)
    images = [f for f in files if f.suffix.lower() in IM_SUFFIXES]
    if images:
        n = run_images(engine, images, savedir, args.show_split, args.batch_size, args.workers)
        print(f"Saved {n} images to {savedir}")
    for f in files:
        if f.suffix.lower() in VID_SUFFIXES:
            run_video(engine, f, savedir, args.show_split, args.batch_size, args.workers)
    print(f"Saved output to {savedir}")


if __name__ == "__main__":
    main()
