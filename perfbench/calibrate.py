"""Readings that the limits of ``correct`` are set from, many seeds in one
process: ``python3 -m perfbench.calibrate --workload <cell> --seeds
<n,n,...> --seconds <s> [--control] [--fault half_batch]``.

Without ``--control``: the program's numbers, one run of the cell per
seed (a short window at the cell's own sizes). With ``--control``: the
lower-precision control's numbers at the same sizes. Video and serving
cells run the program with its own int8 path switched on; the training
cell puts the reference in the program's place with every convolution's
operands rounded to float8 e4m3. ``--fault half_batch`` (training) reads
the reference trained on the first half of each batch, the mean taken
over it, against the whole. Each seed prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def _train_readings(cell, seed: int, conv=None, half_batch: bool = False) -> dict:
    """The training cell's numbers for the reference variant put in the
    program's place, on the data and weights ``seed`` makes."""
    from perfbench import arch as archs
    from perfbench.harness import Run
    from perfbench.reference import compare
    from perfbench.reference import train as train_ref
    from perfbench.traffic import images

    run = Run(cell, seed, 0.0, False, "cuda" if torch.cuda.is_available() else "cpu")
    mix, cfg = run.mix, run.config
    arch = archs.load(cfg)
    params = arch.make_params(cfg, run.generator("weights"), run.device)
    vgg = arch.make_vgg(run.generator("vgg"), run.device)
    raw, ref = images.pairs(run.generator("pairs"), mix["pairs"], mix["height"], mix["width"], run.device)
    raw, ref = raw.cpu().numpy(), ref.cpu().numpy()
    args = (params, vgg, cfg, raw, ref, seed, mix["batch"], mix["setup_steps"], run.device)
    weight = cfg["loss"]["perceptual_weight"]
    want = train_ref.follow(*args, perceptual_weight=weight)
    if half_batch:
        got = _follow_half(*args, perceptual_weight=weight)
    else:
        got = train_ref.follow(*args, conv=conv, perceptual_weight=weight)
    return compare.train_numbers(got, want)


def _follow_half(params0, vgg, spec, raw, ref, seed, batch, steps, device, perceptual_weight):
    """The reference's steps with each batch's second half left out."""
    from perfbench.reference import train as train_ref

    original = train_ref.step_inputs

    def half(*a, **k):
        return [p[: max(1, p.shape[0] // 2)] for p in original(*a, **k)]

    train_ref.step_inputs = half
    try:
        return train_ref.follow(params0, vgg, spec, raw, ref, seed, batch, steps, device,
                                perceptual_weight=perceptual_weight)
    finally:
        train_ref.step_inputs = original


def main(argv=None) -> int:
    from perfbench import harness
    from perfbench.reference.compare import fp8_conv2d

    parser = argparse.ArgumentParser(prog="python3 -m perfbench.calibrate")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--fault", choices=("half_batch",))
    args = parser.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    kind = harness.Cell(args.workload).mix["kind"]
    overrides = {"settings.quantize": True} if args.control and kind != "train" else {}
    cell = harness.Cell(args.workload, overrides=overrides)
    for seed in seeds:
        t = time.perf_counter()
        if kind == "train" and (args.control or args.fault):
            numbers = _train_readings(cell, seed, conv=fp8_conv2d if args.control else None,
                                      half_batch=args.fault == "half_batch")
        else:
            line = harness.run_cell(cell, seed, args.seconds, False, "cuda")
            numbers = dict(line["_numbers"], **line["_notes"])
            numbers["metrics"] = {k: m["value"] for k, m in line["metrics"].items()}
        what = "control" if args.control else (args.fault or "program")
        sys.stdout.write(json.dumps({"workload": args.workload, "seed": seed, "reading": what,
                                     "numbers": numbers, "seconds": time.perf_counter() - t}) + "\n")
        sys.stdout.flush()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
