"""The open loop's knee: ``python3 -m perfbench.sweep --workload <serving
cell> --rates 2,4,... --seconds <s> --seed <n>`` runs the cell's window at
each offered rate in turn on one set-up, and prints per rate the
requests, the latency percentiles, the median latency of the window's
first and last thirds (a backlog that grows shows as the second far above
the first), the batches' slot occupancy and how late the generator ran.
The cell's rate is then set at about 0.8 of the highest rate without a
growing backlog."""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    from perfbench import harness
    from perfbench.traffic import serve

    parser = argparse.ArgumentParser(prog="python3 -m perfbench.sweep")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--rates", required=True)
    parser.add_argument("--seconds", type=float, default=20.0)
    parser.add_argument("--seed", type=int, default=1)
    args = parser.parse_args(argv)
    cell = harness.Cell(args.workload)
    run = harness.Run(cell, args.seed, args.seconds, False, "cuda")
    state = serve.setup(run)
    stats = state["batcher"].stats
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            rcell = harness.Cell(args.workload, overrides={"mix.rate_per_s": rate, "settings.check_requests": 0})
            rrun = harness.Run(rcell, args.seed, args.seconds, False, "cuda")
            real0, total0 = stats.real_slots, stats.total_slots
            out = serve.window(rrun, state)
            occ = (stats.real_slots - real0) / max(1, stats.total_slots - total0)
            sys.stdout.write(json.dumps({"rate_per_s": rate, "attempted": out["attempted"], "failed": out["failed"],
                                         "p95_ms": out["metrics"]["request_p95_ms"], "occupancy": occ,
                                         **out["notes"]}) + "\n")
            sys.stdout.flush()
    finally:
        serve.close(run, state)
    return 0


if __name__ == "__main__":
    sys.exit(main())
