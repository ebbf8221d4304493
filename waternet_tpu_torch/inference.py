"""Image / directory inference CLI of the port.

    python -m waternet_tpu_torch.inference --source img_or_dir \\
        --weights tests/fixtures/distill/teacher.npz [--device-preprocess]

Outputs land in ``<output-root>/<name or next number>/`` under the source
file names, as the JAX package's ``inference.py`` writes them.
Consecutive same-shaped images are stacked into batches of up to
``--batch-size``; a shape change flushes the batch. Decoding is
synchronous. Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

IM_SUFFIXES = [".bmp", ".jpg", ".jpeg", ".png", ".gif"]
VID_SUFFIXES = [".mp4", ".mpeg", ".avi"]
_REPO_ROOT = Path(__file__).resolve().parent.parent


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument(
        "--source", required=True,
        help="Input image or directory of images (bmp, jpg, jpeg, png, gif).",
    )
    p.add_argument(
        "--weights",
        help="Model weights: .npz (JAX format) or the reference's .pt. "
        "Defaults to local weight resolution.",
    )
    p.add_argument("--name", help="Subfolder name under the output root.")
    p.add_argument(
        "--batch-size", type=int, default=4,
        help="Most same-shaped consecutive images per device batch.",
    )
    p.add_argument(
        "--device-preprocess", action="store_true",
        help="Run WB/GC/CLAHE on the device instead of the host.",
    )
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'.")
    p.add_argument(
        "--output-root", default=str(_REPO_ROOT / "output"),
        help="Base directory of the numbered run directories.",
    )
    args = p.parse_args(argv)
    if args.batch_size < 1:
        p.error("--batch-size must be >= 1")
    return args


def _batches(paths, batch_size):
    """Yield lists of (path, rgb) of one shape, at most ``batch_size`` long,
    in path order."""
    import cv2

    pending = []
    for path in paths:
        bgr = cv2.imread(str(path))
        if bgr is None:
            print(f"Skipping unreadable image: {path}", file=sys.stderr)
            continue
        rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        if pending and (
            rgb.shape != pending[0][1].shape or len(pending) == batch_size
        ):
            yield pending
            pending = []
        pending.append((path, rgb))
    if pending:
        yield pending


def run_images(engine, paths, savedir: Path, batch_size: int) -> int:
    """Enhance ``paths`` in same-shape batches; return the images written."""
    import cv2

    written = 0
    for batch in _batches(paths, batch_size):
        out = engine.enhance(np.stack([rgb for _, rgb in batch]))
        savedir.mkdir(parents=True, exist_ok=True)
        for (path, _), out_rgb in zip(batch, out):
            cv2.imwrite(str(savedir / path.name), cv2.cvtColor(out_rgb, cv2.COLOR_RGB2BGR))
            written += 1
    return written


def main(argv=None):
    args = parse_args(argv)
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
    if any(f.suffix.lower() in VID_SUFFIXES for f in files):
        raise SystemExit(
            "video sources are not ported yet: use the JAX package's "
            "inference.py, or split the video into frames"
        )
    print(f"Total images: {len(files)}")
    engine = InferenceEngine(
        weights=args.weights,
        device_preprocess=args.device_preprocess,
        device=args.device,
    )
    savedir = next_run_dir(Path(args.output_root), args.name)
    n = run_images(engine, files, savedir, args.batch_size)
    print(f"Saved {n} images to {savedir}")


if __name__ == "__main__":
    main()
