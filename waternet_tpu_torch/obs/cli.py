"""The trace CLI — read traces, answer "where did the time go".

The JAX package's ``obs/cli.py``, lifted; its printed reports are the
same line for line. Three modes:

``python -m waternet_tpu_torch.obs.cli trace.json``
    Loads a Chrome trace-event file exported by
    :mod:`waternet_tpu_torch.obs.trace` and prints (a) a per-stage latency
    breakdown (count / p50 / p95 / p99 / total per span name), (b)
    critical-path attribution for the slowest requests — each stage of
    the slowest ``request_id`` chains, with re-dispatch hops called out
    — and (c) a span-count / eviction / overhead summary.

``python -m waternet_tpu_torch.obs.cli --train-root <dir>``
    Renders the supervisor timeline from artifacts a supervised run
    writes — the per-generation heartbeat dirs (``gen-NNN/worker-*.json``)
    and ``supervisor-report.json`` — with zero new runtime writes:
    generations with triggers and durations, per-worker state
    transitions, restart/recovery windows. ``--export out.json``
    additionally folds the timeline into Chrome trace form (one pid per
    generation, one tid per worker) so supervisor history opens in the
    same Perfetto UI as serving traces.

``python -m waternet_tpu_torch.obs.cli slo ledger.json --slo "p99_ms<=250,..."``
    Replays a request ledger (``the loadgen --ledger``, or any
    JSON list of ``{"t", "latency_ms", "outcome"}`` rows) through the
    SAME windows and burn-rate state machines the live server runs
    (:mod:`waternet_tpu_torch.obs.slo`), printing every ok/warn/page
    transition with its ledger timestamp and the final per-objective
    burn table. Exit 1 when any objective ends paging — usable as a
    post-hoc gate on a recorded load test. ``--per-worker`` replays
    each worker's entries separately (fleet ledgers carry the
    ``X-Worker-Id`` per answer) so one sick worker's burn is
    attributable offline.

Pure stdlib; imports no torch (safe on hosts without an accelerator).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

from waternet_tpu_torch.resilience.heartbeat import read_heartbeat

PROG = "python -m waternet_tpu_torch.obs.cli"


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile, same convention as serving/stats.py."""
    if not sorted_vals:
        return 0.0
    k = max(0, min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[k]


def _load_events(path: Path) -> tuple:
    doc = json.loads(path.read_text())
    if isinstance(doc, list):  # bare event-array form is also legal
        return doc, {}
    return doc.get("traceEvents", []), doc.get("otherData", {})


def _stage_table(events: List[dict], out) -> None:
    stages: Dict[str, List[float]] = {}
    for ev in events:
        if ev.get("ph") == "X":
            stages.setdefault(ev["name"], []).append(ev.get("dur", 0.0) / 1e3)
    print("per-stage latency (ms):", file=out)
    header = f"  {'stage':<16} {'count':>7} {'p50':>9} {'p95':>9} {'p99':>9} {'total':>10}"
    print(header, file=out)
    for name in sorted(stages, key=lambda n: -sum(stages[n])):
        durs = sorted(stages[name])
        print(
            f"  {name:<16} {len(durs):>7} "
            f"{_percentile(durs, 0.50):>9.3f} "
            f"{_percentile(durs, 0.95):>9.3f} "
            f"{_percentile(durs, 0.99):>9.3f} "
            f"{sum(durs):>10.3f}",
            file=out,
        )


def _request_groups(events: List[dict]) -> Dict[str, List[dict]]:
    groups: Dict[str, List[dict]] = {}
    for ev in events:
        rid = (ev.get("args") or {}).get("request_id")
        if rid is not None:
            groups.setdefault(str(rid), []).append(ev)
    return groups


def _critical_path(groups: Dict[str, List[dict]], slowest: int, out) -> None:
    """Per-request attribution for the slowest request chains."""
    walls = []
    for rid, evs in groups.items():
        spans = [e for e in evs if e.get("ph") == "X"]
        if not spans:
            continue
        t0 = min(e["ts"] for e in spans)
        t1 = max(e["ts"] + e.get("dur", 0.0) for e in spans)
        walls.append((t1 - t0, rid, spans, evs))
    walls.sort(key=lambda w: (-w[0], w[1]))
    if not walls:
        print("no request-correlated spans in this trace", file=out)
        return
    print(f"\ncritical path, slowest {min(slowest, len(walls))} "
          f"of {len(walls)} requests:", file=out)
    for wall_us, rid, spans, evs in walls[:slowest]:
        wall_ms = wall_us / 1e3
        hops = [e for e in evs if e.get("ph") == "i" and e["name"] == "redispatch"]
        hop_note = f", {len(hops)} re-dispatch hop(s)" if hops else ""
        print(f"  request {rid}: {wall_ms:.3f} ms{hop_note}", file=out)
        for e in sorted(spans, key=lambda e: -e.get("dur", 0.0)):
            dur_ms = e.get("dur", 0.0) / 1e3
            share = 100.0 * dur_ms / wall_ms if wall_ms > 0 else 0.0
            print(f"    {e['name']:<16} {dur_ms:>9.3f} ms  {share:>5.1f}%", file=out)


def _analyze(path: Path, slowest: int, out=None) -> int:
    out = out or sys.stdout  # bind late: tests capture sys.stdout
    events, other = _load_events(path)
    spans = sum(1 for e in events if e.get("ph") == "X")
    instants = sum(1 for e in events if e.get("ph") == "i")
    _stage_table(events, out)
    _critical_path(_request_groups(events), slowest, out)
    print(
        f"\nspan summary: {spans} spans, {instants} instants"
        + (
            f"; recorder evicted {other.get('evicted', 0)} "
            f"of capacity {other.get('capacity', '?')}"
            if other
            else ""
        ),
        file=out,
    )
    return 0


# ---------------------------------------------------------------------------
# Supervisor timeline (--train-root)
# ---------------------------------------------------------------------------

#: The heartbeat state machine's nominal forward path, used to render the
#: implied transition chain for a worker's final state.
_CHAIN = {
    "starting": ["starting"],
    "running": ["starting", "running"],
    "late": ["starting", "running", "late"],
    "presumed-hung": ["starting", "running", "late", "presumed-hung"],
    "dead": ["starting", "running", "dead"],
    "done": ["starting", "running", "done"],
}


def _gen_beats(gen_dir: Path) -> Dict[int, dict]:
    beats = {}
    for p in sorted(gen_dir.glob("worker-*.json")):
        rec = read_heartbeat(p)
        if rec is not None:
            beats[int(rec.get("process_id", 0))] = rec
    return beats


def _train_timeline(root: Path, export: Optional[str], out=None) -> int:
    out = out or sys.stdout  # bind late: tests capture sys.stdout
    report_path = root / "supervisor-report.json"
    report = None
    if report_path.exists():
        report = json.loads(report_path.read_text())
    gen_dirs = sorted(root.glob("gen-*"))
    if report is None and not gen_dirs:
        print(f"{PROG}: no supervisor artifacts under {root}",
              file=sys.stderr)
        return 1

    print(f"supervisor timeline: {root}", file=out)
    if report is not None:
        rec = ", ".join(f"{r:.1f}s" for r in report.get("recovery_sec", []))
        print(
            f"  result={report['result']} restarts={report['restarts']}"
            + (f" recovery=[{rec}]" if rec else ""),
            file=out,
        )
    generations = (report or {}).get("generations", [])
    by_gen = {g["generation"]: g for g in generations}
    gen_ids = sorted(
        set(by_gen)
        | {int(d.name.split("-")[1]) for d in gen_dirs if d.name[4:].isdigit()}
    )
    trace_events: List[dict] = []
    t_cursor = 0.0
    for gid in gen_ids:
        gen = by_gen.get(gid, {})
        trigger = gen.get("trigger")
        dur = float(gen.get("duration_sec", 0.0))
        print(
            f"  generation {gid}: "
            f"{'trigger=' + trigger if trigger else 'completed'}"
            f" duration={dur:.1f}s",
            file=out,
        )
        beats = _gen_beats(root / f"gen-{gid:03d}")
        for rank, w in enumerate(gen.get("workers", [])):
            chain = " -> ".join(_CHAIN.get(w["state"], [w["state"]]))
            beat = beats.get(rank)
            beat_note = (
                f" (last beat: step {beat['step']}, phase {beat['phase']},"
                f" seq {beat['seq']})"
                if beat
                else ""
            )
            print(
                f"    worker {rank}: {chain} rc={w['exit_code']}"
                f" first_step={w['first_step']} last_step={w['last_step']}"
                f"{beat_note}",
                file=out,
            )
            trace_events.append({
                "name": f"worker {rank}",
                "cat": "supervisor",
                "ph": "X",
                "pid": gid,
                "tid": rank + 1,
                "ts": round(t_cursor * 1e6, 3),
                "dur": round(dur * 1e6, 3),
                "args": dict(w, generation=gid),
            })
        trace_events.append({
            "name": f"generation {gid}",
            "cat": "supervisor",
            "ph": "X",
            "pid": gid,
            "tid": 0,
            "ts": round(t_cursor * 1e6, 3),
            "dur": round(dur * 1e6, 3),
            "args": {"trigger": trigger},
        })
        if trigger is not None:
            print(f"    restart window opens ({trigger})", file=out)
        t_cursor += dur
    if report is not None:
        for i, r in enumerate(report.get("recovery_sec", [])):
            print(f"  recovery window {i}: {r:.1f}s to next first beat",
                  file=out)
    if export:
        Path(export).write_text(json.dumps({
            "traceEvents": trace_events,
            "displayTimeUnit": "ms",
            "otherData": {"source": str(root)},
        }))
        print(f"  exported Chrome trace: {export}", file=out)
    return 0


# ---------------------------------------------------------------------------
# SLO ledger replay (the slo subcommand)
# ---------------------------------------------------------------------------


def _load_ledger(path: Path) -> list:
    """Accept a bare entry list, ``{"ledger": [...]}``, or a full
    loadgen report that embedded its ledger."""
    doc = json.loads(path.read_text())
    if isinstance(doc, list):
        return doc
    if isinstance(doc, dict) and isinstance(doc.get("ledger"), list):
        return doc["ledger"]
    raise ValueError(
        "expected a JSON list of ledger entries or an object with a "
        "'ledger' key"
    )


def _replay_one(out, label, entries, objectives, args) -> bool:
    """Replay one entry group; prints the standard report, returns
    whether any objective ended in ``page``."""
    from waternet_tpu_torch.obs.slo import replay_ledger

    transitions, block = replay_ledger(
        entries,
        objectives,
        step_sec=args.step_sec,
        short_sec=args.short_sec,
        long_sec=args.long_sec,
        hold_sec=args.hold_sec,
    )
    n = len(entries)
    span = max((float(e.get("t", 0.0)) for e in entries), default=0.0)
    print(f"slo replay{label}: {n} ledger entries over {span:.1f}s "
          f"(windows {args.short_sec:g}s/{args.long_sec:g}s, "
          f"eval every {args.step_sec:g}s)", file=out)
    if transitions:
        print("transitions:", file=out)
        for tr in transitions:
            print(f"  t={tr['at']:>9.1f}s  {tr['objective']:<24} "
                  f"{tr['from']} -> {tr['to']}", file=out)
    else:
        print("transitions: none", file=out)
    print("final state:", file=out)
    print(f"  {'objective':<24} {'state':<6} {'short_burn':>10} "
          f"{'long_burn':>10}", file=out)
    paging = False
    for row in block.get("objectives", []):
        print(f"  {row['objective']:<24} {row['state']:<6} "
              f"{row['short_burn']:>10.3f} {row['long_burn']:>10.3f}",
              file=out)
        paging = paging or row["state"] == "page"
    print(f"grade: {block.get('grade', 'ok')}", file=out)
    return paging


def _slo_replay(args, out=None) -> int:
    out = out or sys.stdout  # bind late: tests capture sys.stdout
    from waternet_tpu_torch.obs.slo import parse_slo

    path = Path(args.ledger)
    try:
        entries = _load_ledger(path)
        objectives = parse_slo(args.slo)
    except (OSError, ValueError) as e:
        print(f"{PROG} slo: {e}", file=sys.stderr)
        return 2
    if not args.per_worker:
        paging = _replay_one(out, "", entries, objectives, args)
        return 1 if paging else 0
    # Per-worker attribution : fleet ledgers
    # carry the X-Worker-Id each answer was stamped with, so replaying
    # each worker's entries separately shows WHOSE latency/errors burned
    # the budget — one sick worker is findable offline, after the run.
    groups: Dict[str, list] = {}
    for e in entries:
        groups.setdefault(e.get("worker") or "unattributed", []).append(e)
    paging = False
    for worker in sorted(groups):
        hot = _replay_one(
            out, f" [worker {worker}]", groups[worker], objectives, args
        )
        paging = paging or hot
        print(file=out)
    print(f"workers replayed: {len(groups)}", file=out)
    return 1 if paging else 0


def build_slo_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=f"{PROG} slo",
        description="Replay a loadgen/bench request ledger through the "
        "serving SLO burn-rate engine, offline.",
    )
    p.add_argument("ledger",
                   help="ledger JSON (the loadgen --ledger output, "
                        "a bare entry list, or a report with a 'ledger' key)")
    p.add_argument("--slo", required=True, metavar="SPEC",
                   help='objectives, e.g. "p99_ms<=250,error_rate<=0.01"')
    p.add_argument("--step-sec", type=float, default=1.0,
                   help="engine evaluation cadence in ledger time")
    p.add_argument("--short-sec", type=float, default=60.0,
                   help="fast burn window")
    p.add_argument("--long-sec", type=float, default=300.0,
                   help="sustained burn window")
    p.add_argument("--hold-sec", type=float, default=60.0,
                   help="quiet time required before de-escalation")
    p.add_argument("--per-worker", action="store_true", default=False,
                   help="replay each worker's entries separately (fleet "
                        "ledgers carry X-Worker-Id per answer, "
                        "the loadgen --per-worker) to attribute a "
                        "burn to the worker that caused it")
    return p


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=PROG,
        description="Analyze waternet trace files and supervisor timelines.",
    )
    p.add_argument("trace", nargs="?",
                   help="Chrome trace-event JSON exported by waternet_tpu_torch.obs")
    p.add_argument("--slowest", type=int, default=3, metavar="N",
                   help="requests to attribute in the critical-path section")
    p.add_argument("--train-root", metavar="DIR",
                   help="render a supervisor timeline from a heartbeat dir")
    p.add_argument("--export", metavar="OUT",
                   help="with --train-root: also write the timeline as a "
                        "Chrome trace-event file")
    return p


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "slo":
        return _slo_replay(build_slo_parser().parse_args(argv[1:]))
    args = build_parser().parse_args(argv)
    if args.train_root:
        return _train_timeline(Path(args.train_root), args.export)
    if not args.trace:
        build_parser().error("a trace file or --train-root is required")
    path = Path(args.trace)
    if not path.exists():
        print(f"{PROG}: no such trace file: {path}", file=sys.stderr)
        return 1
    return _analyze(path, max(1, args.slowest))


if __name__ == "__main__":
    sys.exit(main())
