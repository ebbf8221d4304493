"""The benchmark of ``waternet_tpu_torch``: one run of one cell.

``python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the repository's root. The cell's entry in
``BENCHMARK.json`` names its configuration and traffic; everything else is
found by name:

* ``perfbench/configs/<config>.json``: the configuration as run (its
  ``arch`` names ``perfbench/arch/<arch>.py``, the weights, engines and
  plain reference);
* ``perfbench/traffic/<traffic>.json``: the traffic mix (its ``kind``
  names the driver ``perfbench/traffic/<kind>.py``);
* ``perfbench/workloads/<cell>.json``: the cell's own settings: the
  profiler's sub-window, the sample the reference checks, and each
  compared number's limit;
* ``perfbench/metrics/<metric>.py``: the reader of each per-layer metric
  ``BENCHMARK.json`` lists for the cell.

A cell not yet in ``BENCHMARK.json`` is looked up in
``perfbench/pending.json``, which has the same keys: cells built and
tested here that do not yet hold to the benchmark's bounds (``PERF.md``,
Open questions). The driver runs only the cells of ``BENCHMARK.json``.

A run builds and warms the system (set-up, ``setup_s``), measures for
``--seconds`` (the window), and with ``--trace 1`` goes on for the cell's
``profile_seconds`` under ``torch.profiler`` with the program's spans
armed; then it frees the program's state, compares what the window
produced with the plain reference, and prints one JSON line.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import random
import statistics
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import torch

from perfbench import profiling

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
#: Top-level module names the benchmark's process may never hold.
FORBIDDEN = ("jax", "jaxlib", "flax", "waternet_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole (``waternet_tpu_torch`` is not ``waternet_tpu``)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    """``BENCHMARK.json`` with the entries of ``perfbench/pending.json``
    that it does not name added after its own."""
    bench = load_json(REPO / "BENCHMARK.json")
    path = ROOT / "pending.json"
    if path.is_file():
        for key, entries in load_json(path).items():
            names = {e["name"] for e in bench[key]}
            bench[key] = bench[key] + [e for e in entries if e["name"] not in names]
    return bench


class Cell:
    """A cell's files, resolved by name from ``BENCHMARK.json``."""

    def __init__(self, name: str, overrides: dict | None = None):
        """``overrides``: {"config.<key>" | "mix.<key>" | "settings.<key>":
        value}, for the tests' small sizes and the calibration's controls."""
        bench = benchmark()
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json or perfbench/pending.json")
        self.name = name
        self.entry = entries[name]
        self.chips = int(self.entry["chips"])
        cfg = next(c for c in bench["configs"] if c["name"] == self.entry["config"])
        self.config = load_json(REPO / cfg["file"])
        self.mix = load_json(ROOT / "traffic" / f"{self.entry['traffic']}.json")
        self.settings = load_json(ROOT / "workloads" / f"{name}.json")
        for key, val in (overrides or {}).items():
            part, field = key.split(".", 1)
            getattr(self, part)[field] = val
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]


class Run:
    """What a driver and the metric readers share in one run."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device):
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.config, self.mix, self.settings = cell.config, cell.mix, cell.settings
        self.device = torch.device(device)
        self.host: dict = {}  # host-clock records of the window, by name
        self.profile: dict | None = None
        self.profile_units: dict = {}
        self.spans: list = []  # the program's spans inside the window
        self._profiler = None
        self._t0 = None
        self.marks: list = []  # (label, perf_counter) of set-up's stages

    def mark(self, label: str) -> None:
        self.marks.append((label, time.perf_counter()))

    # -- seeds -------------------------------------------------------------

    def subseed(self, tag: str) -> int:
        """A 63-bit seed for ``tag`` from the run's seed."""
        state = np.random.SeedSequence([self.seed, zlib.crc32(tag.encode())]).generate_state(1, np.uint64)[0]
        return int(state) >> 1

    def generator(self, tag: str) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(self.subseed(tag))

    def rng(self, tag: str) -> random.Random:
        return random.Random(self.subseed(tag))

    # -- the window --------------------------------------------------------

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start_window(self) -> float:
        if self.trace:
            from waternet_tpu_torch.obs import trace

            trace.reset()
            trace.enable()
        self._t0 = time.perf_counter()
        return self._t0

    def window_over(self) -> bool:
        return time.perf_counter() - self._t0 >= self.seconds

    def end_window(self, t1: float) -> None:
        """With tracing, keep the program's spans that start inside the
        window, which ends at ``t1``."""
        if self.trace:
            from waternet_tpu_torch.obs import trace

            events, _ = trace.recorder().snapshot()
            self.spans = [e for e in events if self._t0 <= e[3] <= t1]

    def start_profile(self) -> None:
        """The profiled sub-window: its first half records the device alone
        (busy and idle shares, kernel times, the idle gaps), its second half
        the host's operators too (the device time under each operator)."""
        self._profiler = profiling.Profile(self.device, host=False)
        self._clock = time.time() - time.perf_counter()  # wall clock minus perf_counter
        self._profiler.start()
        self._tp = time.perf_counter()
        self._device_part = None

    def profile_over(self, units: int = 0) -> bool:
        """Polled by the driver at each boundary with the units (frames,
        steps) it has issued since :meth:`start_profile`."""
        elapsed = time.perf_counter() - self._tp
        total = float(self.settings["profile_seconds"])
        if self._device_part is None and elapsed >= total / 2:
            self._device_part = self._profiler.stop()
            self.profile_units = {"device": units}
            self._profiler = profiling.Profile(self.device, host=True)
            self._profiler.start()
        return elapsed >= total

    def stop_profile(self, units: int = 0) -> None:
        host = self._profiler.stop()
        self._profiler = None
        dev = self._device_part
        self.profile_units["host"] = units - self.profile_units["device"]
        self.profile = dict(dev, op_device_s=host["op_device_s"], idle_gaps=self._label_gaps(dev["gaps"]))

    def _label_gaps(self, gaps) -> list:
        """[[what the host was doing, seconds]] of the device-only half's
        longest idle gaps: the innermost span (the program's, or the
        harness's around its calls) open at each gap's middle."""
        from waternet_tpu_torch.obs import trace

        spans = [e for e in trace.recorder().snapshot()[0] if e[2] == "X"]
        out = []
        for dur, mid_wall in gaps:
            label = "no span open"
            if mid_wall is None:
                label = "not aligned"
            else:
                mid = mid_wall - self._clock
                open_ = [e for e in spans if e[3] <= mid <= e[3] + e[4]]
                if open_:
                    label = min(open_, key=lambda e: e[4])[0]
            out.append([label, dur])
        return out

    # -- readers' helpers --------------------------------------------------

    def span_ms(self, name: str) -> list:
        return [e[4] * 1e3 for e in self.spans if e[0] == name and e[2] == "X"]

    def peak(self, key: str):
        """The card's published peak ``key`` from ``peaks.json``, or None
        for a card it does not list (never a guess)."""
        if self.device.type != "cuda":
            return None
        name = torch.cuda.get_device_name(self.device)
        for card in load_json(ROOT / "peaks.json")["cards"]:
            if card["match"] in name:
                return card[key]
        return None


def read_metric(run: Run, name: str):
    """The per-layer metric ``name`` from its reader file, or None."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def percentile(values, q: float) -> float:
    """Linear interpolation between closest ranks (numpy's default)."""
    s = sorted(values)
    pos = q * (len(s) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def median(values):
    return statistics.median(values) if values else None


def device_block(device: torch.device, count: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i) for i in range(count)))}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda", t_start=None) -> dict:
    """One run; returns the result line's object (and, under ``_notes`` and
    ``_numbers``, what :func:`main` prints on standard error)."""
    t_start = time.perf_counter() if t_start is None else t_start
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    run = Run(cell, seed, seconds, trace, device)
    driver = importlib.import_module(f"perfbench.traffic.{cell.mix['kind']}")
    state = driver.setup(run)
    if trace:
        profiling.warm(run.device)
        run.mark("profiler")
    setup_s = time.perf_counter() - t_start
    try:
        out = driver.window(run, state)
    except BaseException:
        driver.close(run, state)  # stop and join what the driver started
        raise
    finally:
        if trace:
            from waternet_tpu_torch.obs import trace as spans

            spans.disable()
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of the JAX package loaded: {', '.join(found)}")
    dev = device_block(run.device, cell.chips)
    metrics = {}
    if trace:
        dev["busy_s"] = run.profile["busy_s"]
        dev["window_s"] = run.profile["window_s"]
        for m in cell.per_layer:
            value = read_metric(run, m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        # A cell may report a driver's rate under a name of its own
        # (``metric_names`` in its settings): cells of one traffic kind whose
        # runs spread differently take bounds of their own.
        names = cell.settings.get("metric_names", {})
        values = {names.get(k, k): v for k, v in out["metrics"].items()}
        values["setup_s"] = setup_s
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    driver.close(run, state)
    numbers = driver.check(run, state)
    limits = cell.settings["limits"]
    # A number that is missing or not finite fails its limit; it prints as null.
    values = {k: numbers.get(k) for k in limits}
    values = {k: v if v is not None and math.isfinite(v) else None for k, v in values.items()}
    checks = {k: {"value": values[k], "limit": lim} for k, lim in limits.items()}
    line = {
        "correct": all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values()),
        "attempted": int(out["attempted"]),
        "failed": int(out["failed"]),
        "metrics": metrics,
        "device": dev,
    }
    if trace:
        line["breakdown"] = {"device_ops": run.profile["device_ops"], "idle_gaps": run.profile["idle_gaps"]}
    line["checks"] = checks
    notes = dict(out.get("notes", {}))
    if trace:
        notes["profile.clock_offset_ms"] = run.profile["clock_offset_s"] * 1e3
    prev = t_start
    for label, t in run.marks:
        notes[f"setup.{label}_s"], prev = t - prev, t
    line["_notes"] = notes
    line["_numbers"] = numbers
    return line


def main(argv=None, t_start=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="python3 -m perfbench.run")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        sys.stderr.write(f"perfbench: {args.workload} needs {cell.chips} CUDA device(s); "
                         f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}\n")
        return 2
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    notes = line.pop("_notes")
    notes["numbers"] = line.pop("_numbers")
    if notes:
        sys.stderr.write("notes " + json.dumps(notes) + "\n")
    found = forbidden_modules()
    if found:
        sys.stderr.write(f"perfbench: modules of the JAX package loaded: {', '.join(found)}\n")
        return 3
    sys.stderr.write("".join(f"check {k} = {c['value']!r} (limit {c['limit']!r})\n"
                             for k, c in line["checks"].items()))
    sys.stderr.flush()
    sys.stdout.write(json.dumps(line) + "\n")
    sys.stdout.flush()
    return 0
