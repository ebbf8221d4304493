"""Scoring CLI of the port: evaluate a checkpoint on the UIEB split, or on
raw images with no reference.

    python -m waternet_tpu_torch.score --weights last.npz --data-root data
    python -m waternet_tpu_torch.score --weights last.npz --raw-dir challenging-60/

The port of the JAX package's ``score.py``, with its flags and its metric
dict, key for key (``--epochs`` and ``--seed`` are accepted and ignored,
as that scorer does, with its warning for a seed other than 0):

* **paired** (default): the reference's seed-0 split of the pairs under
  ``--data-root`` (``--split val|train|all``), scored by the training
  engine's eval (mse / ssim / psnr / perceptual_loss, each the equal-weight
  mean over minibatches), host (cv2) preprocessing by default,
  ``--device-preprocess`` to run the transforms on the device.
  ``--bug-compat-perceptual`` reproduces the reference's perceptual_loss
  accumulation defect (the last batch's value over the batch count).
  Evaluation is unaugmented, as in the JAX scorer.
* **no reference** (``--raw-dir``): UCIQE and UIQM of the raw images and
  of their enhancement by the port's ``InferenceEngine`` in
  ``--precision``, at native resolution (files grouped by the shape
  their header gives), or at ``--height`` x ``--width`` with
  ``--nr-resize``.

Prints the metric dict; ``--json-out`` also writes it. Runs on CUDA unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from pprint import pprint

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--weights", required=True, help="Checkpoint (.npz in the JAX layout, or the reference's .pt).")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--height", type=int, default=112)
    p.add_argument("--width", type=int, default=112)
    p.add_argument("--data-root", default="data", help="UIEB root holding raw-890/ and reference-890/.")
    p.add_argument("--val-size", type=int, default=90)
    p.add_argument("--split", default="val", choices=["val", "train", "all"],
                   help="Which part of the seed-0 split to score (reference: val).")
    p.add_argument("--allow-nonreference-split", action="store_true",
                   help="(Compat) accepted: the port draws the split with torch, so it is always the reference's.")
    p.add_argument("--vgg-weights", help="VGG19 weights for the perceptual metric.")
    p.add_argument("--precision", default="fp32", choices=["bf16", "fp32"])
    p.add_argument("--device-preprocess", action="store_true")
    p.add_argument("--workers", type=int, default=2, metavar="N",
                   help="Input pipeline: N worker threads load and preprocess eval batches ahead of the "
                   "device; 0 = synchronous. The metric values are identical either way.")
    p.add_argument("--bug-compat-perceptual", action="store_true",
                   help="Reproduce the reference's perceptual_loss accumulation bug.")
    p.add_argument("--json-out", help="Also write the metrics to this JSON file.")
    p.add_argument("--epochs", type=int, default=None,
                   help="(Compat) accepted and ignored: the reference scorer inherited this flag from "
                   "train.py and never uses it.")
    p.add_argument("--seed", type=int, default=None,
                   help="(Compat) in the reference, a non-None seed reseeds torch's global RNG before "
                   "random_split, silently changing WHICH 90 images count as val; this scorer always "
                   "evaluates the canonical seed-0 split and warns if a different seed is requested.")
    p.add_argument("--raw-dir",
                   help="Score a directory of raw images with no references by UCIQE/UIQM, before and after "
                   "enhancement, at native resolution (images batched by shape).")
    p.add_argument("--nr-resize", action="store_true",
                   help="(with --raw-dir) resize to --height x --width first; the values are then not "
                   "comparable to native-resolution numbers.")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'.")
    return p.parse_args(argv)


def score_no_reference(args, dev) -> dict:
    """UCIQE/UIQM of the raw images under ``args.raw_dir`` and of their
    enhancement, averaged over the images. Files are grouped by the shape
    their header gives (a full decode only where it gives none); a file
    whose decode disagrees with its header is re-queued under the decoded
    shape."""
    import cv2

    from waternet_tpu_torch.inference_engine import InferenceEngine
    from waternet_tpu_torch.training.metrics_nr import uciqe_batch, uiqm_batch
    from waternet_tpu_torch.utils.imagemeta import image_shape

    files = sorted(
        p for p in Path(args.raw_dir).glob("*") if p.suffix.lower() in (".png", ".jpg", ".jpeg", ".bmp")
    )
    if not files:
        raise FileNotFoundError(f"no images found in {args.raw_dir}")
    engine = InferenceEngine(
        weights=args.weights,
        device_preprocess=args.device_preprocess,
        device=dev,
        dtype=torch.bfloat16 if args.precision == "bf16" else torch.float32,
    )

    groups: dict = {}
    for f in files:
        if args.nr_resize:
            shape = (args.height, args.width, 3)
        else:
            shape = image_shape(f)
            if shape is None:
                bgr = cv2.imread(str(f))
                if bgr is None:
                    print(f"Skipping unreadable image: {f}", file=sys.stderr)
                    continue
                shape = bgr.shape
        groups.setdefault(shape, []).append(f)

    sums = {"uciqe_raw": 0.0, "uiqm_raw": 0.0, "uciqe_enhanced": 0.0, "uiqm_enhanced": 0.0}
    n_scored = 0
    work = list(groups.items())
    regrouped: dict = {}
    while work:
        shape, paths = work.pop(0)
        for start in range(0, len(paths), args.batch_size):
            raws = []
            for f in paths[start : start + args.batch_size]:
                bgr = cv2.imread(str(f))
                if bgr is None:
                    print(f"Skipping unreadable image: {f}", file=sys.stderr)
                    continue
                if args.nr_resize:
                    bgr = cv2.resize(bgr, (args.width, args.height))
                elif bgr.shape != shape:
                    regrouped.setdefault(bgr.shape, []).append(f)
                    continue
                raws.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
            if not raws:
                continue
            raw = np.stack(raws)
            out = engine.enhance(raw)
            for side, batch in (("raw", raw), ("enhanced", out)):
                t = torch.from_numpy(batch).to(engine.device)
                sums[f"uciqe_{side}"] += float(uciqe_batch(t).sum())
                sums[f"uiqm_{side}"] += float(uiqm_batch(t).sum())
            n_scored += len(raws)
        if not work and regrouped:
            work, regrouped = list(regrouped.items()), {}
    if n_scored == 0:
        raise FileNotFoundError(f"no readable images in {args.raw_dir}")
    return {k: v / n_scored for k, v in sums.items()} | {"images": n_scored}


def _eval_bug_compat(engine, dataset, indices, batch_size: int) -> dict:
    """The reference's ``train.py:71``: perceptual_loss is overwritten per
    batch, so the reported value is last_batch_perceptual / n_batches."""
    sums = {"mse": 0.0, "ssim": 0.0, "psnr": 0.0}
    last_perc = 0.0
    count = 0
    engine.model.eval()
    for raw, ref in dataset.batches(indices, batch_size, shuffle=False):
        arrays = engine._host_preprocess_np(raw, ref) if engine.config.host_preprocess else (raw, ref)
        m = engine._eval_on(engine._feed(arrays), raw.shape[0])
        for k in sums:
            sums[k] += float(m[k])
        last_perc = float(m["perceptual_loss"])
        count += 1
    out = {k: v / max(count, 1) for k, v in sums.items()}
    out["perceptual_loss"] = last_perc / max(count, 1)
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.seed not in (None, 0):
        import warnings

        warnings.warn(
            f"--seed {args.seed} is accepted for reference CLI compatibility "
            "only: this scorer always evaluates the canonical seed-0 split "
            "(the reference would have moved images between train and val).",
            RuntimeWarning,
            stacklevel=1,
        )
    t0 = time.perf_counter()
    from waternet_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)

    if args.raw_dir:
        metrics = score_no_reference(args, dev)
        pprint(metrics)
        print(f"Scored {metrics['images']} raw images in {time.perf_counter() - t0:.1f}s")
    else:
        from waternet_tpu_torch.data.uieb import UIEBDataset, reference_split
        from waternet_tpu_torch.hub import resolve_weights
        from waternet_tpu_torch.models.vgg import resolve_vgg_params
        from waternet_tpu_torch.training.trainer import TrainConfig, TrainingEngine

        root = Path(args.data_root)
        dataset = UIEBDataset(
            root / "raw-890", root / "reference-890", im_height=args.height, im_width=args.width
        )
        train_idx, val_idx = reference_split(len(dataset), n_val=args.val_size)
        indices = {"val": val_idx, "train": train_idx, "all": np.arange(len(dataset))}[args.split]
        params = resolve_weights(args.weights)
        config = TrainConfig(
            batch_size=args.batch_size,
            im_height=args.height,
            im_width=args.width,
            precision=args.precision,
            host_preprocess=not args.device_preprocess,
            augment=False,
        )
        engine = TrainingEngine(
            config, params=params, vgg_params=resolve_vgg_params(args.vgg_weights), device=dev
        )
        if args.bug_compat_perceptual:
            metrics = _eval_bug_compat(engine, dataset, indices, args.batch_size)
        elif args.workers > 0:
            metrics = engine.eval_epoch_pipelined(dataset, indices, workers=args.workers)
            # The scorer reports the metric dict only; train.py reports the
            # pipeline's instrumentation.
            metrics = {k: v for k, v in metrics.items() if not k.startswith("pipeline_")}
        else:
            metrics = engine.eval_epoch(dataset.batches(indices, args.batch_size, shuffle=False))
        pprint(metrics)
        print(f"Scored {len(indices)} images in {time.perf_counter() - t0:.1f}s")
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(metrics, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
