"""Compare the training bench of two checkouts on one card, in pairs.

    python -m waternet_tpu_torch.bench_ab --parent ../parent [--pairs 10] [-- BENCH ARGS]

Runs ``python -m waternet_tpu_torch.bench`` (with the arguments after
``--``) from the ``--parent`` checkout and from this one, ``--pairs``
times each, alternating which side runs first (pair 1 parent first, pair 2
this tree first, ...), so drift over the call falls on both sides alike.
Prints one JSON line per run (``pair``, ``side``, each metric's value),
then one per metric and side: the median, the quartiles, and how many
pairs this tree won. Every run is a fresh process on the same card; the
card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

_HERE = Path(__file__).resolve().parent.parent


def bench_values(cwd: Path, args: list) -> dict:
    """One bench run in ``cwd``: {metric: value} of its JSON lines."""
    proc = subprocess.run([sys.executable, "-m", "waternet_tpu_torch.bench", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=1200)
    if proc.returncode != 0:
        raise SystemExit(f"bench in {cwd} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    return {d["metric"]: d["value"] for d in lines if "metric" in d}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    bench_args = argv[argv.index("--") + 1:] if "--" in argv else []
    own = argv[: argv.index("--")] if "--" in argv else argv
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--parent", required=True, help="Root of the other checkout (e.g. an unpacked git archive).")
    p.add_argument("--pairs", type=int, default=10, help="Pairs of runs (default 10).")
    args = p.parse_args(own)
    sides = {"parent": Path(args.parent).resolve(), "change": _HERE}
    from waternet_tpu_torch.utils.device import gpu_card_line

    print(gpu_card_line(), flush=True)
    runs = {"parent": [], "change": []}
    for pair in range(1, args.pairs + 1):
        order = ("parent", "change") if pair % 2 else ("change", "parent")
        for side in order:
            values = bench_values(sides[side], bench_args)
            runs[side].append(values)
            print(json.dumps({"pair": pair, "side": side, **values}), flush=True)
    for metric in runs["change"][0]:
        got = {side: [r[metric] for r in rs] for side, rs in runs.items()}
        wins = sum(c > b for c, b in zip(got["change"], got["parent"]))
        for side, v in got.items():
            q1, _, q3 = statistics.quantiles(v, n=4) if len(v) > 1 else (v[0], v[0], v[0])
            print(json.dumps({"metric": metric, "side": side, "n": len(v), "median": statistics.median(v),
                              "q1": q1, "q3": q3, "change_wins": wins}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
