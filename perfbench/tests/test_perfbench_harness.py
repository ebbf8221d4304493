"""The harness: the last line's schema, files found by name, the JAX check,
and the refusal without a card or without the program."""

import io
import json
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from perfbench import harness
from perfbench.tests.helpers import SEED, TINY

REPO = harness.REPO


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_schema(monkeypatch, trace):
    """``main`` on a (pretended) card: one JSON line, last on stdout, with
    the driver's keys, ``checks`` last, and the numbers on stderr."""
    name = "can24.video_1080p"
    real = harness.run_cell
    monkeypatch.setattr(harness.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(harness.torch.cuda, "device_count", lambda: 1)
    real_cell = harness.Cell
    monkeypatch.setattr(harness, "Cell", lambda n: real_cell(n, overrides=TINY[n]))
    monkeypatch.setattr(harness, "run_cell", lambda cell, s, sec, tr, dev, t: real(cell, s, sec, tr, "cpu", t))
    out, err = io.StringIO(), io.StringIO()
    monkeypatch.setattr(sys, "stdout", out)
    monkeypatch.setattr(sys, "stderr", err)
    rc = harness.main(["--workload", name, "--seed", str(SEED), "--seconds", "0.5", "--trace", str(trace)])
    assert rc == 0
    lines = out.getvalue().splitlines()
    line = json.loads(lines[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {"student_frames_per_s", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    tail = err.getvalue().splitlines()[-len(line["checks"]):]
    for (key, c), text in zip(line["checks"].items(), tail):
        assert set(c) == {"value", "limit"}
        assert text.startswith(f"check {key} = ")


def test_main_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(harness.torch.cuda, "is_available", lambda: False)
    assert harness.main(["--workload", "waternet.video_1080p", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_cells_resolve_their_metrics():
    """Every cell, of BENCHMARK.json and of pending.json, finds its files,
    at least two end-to-end metrics with setup_s among them, and readers
    that move one of them."""
    own = {w["name"] for w in harness.load_json(REPO / "BENCHMARK.json")["workloads"]}
    pending = {w["name"] for w in harness.load_json(harness.ROOT / "pending.json")["workloads"]}
    assert own and not own & pending
    for w in harness.benchmark()["workloads"]:
        cell = harness.Cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert (harness.ROOT / "metrics" / f"{m['name']}.py").is_file()
            assert m["moves"] in e2e
        assert (harness.ROOT / "traffic" / f"{cell.mix['kind']}.py").is_file()


def _copy_bench(tmp_path, with_program=True):
    """BENCHMARK.json and perfbench/ in a fresh directory (with the program
    beside them, or without it)."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    if with_program:
        (tmp_path / "waternet_tpu_torch").symlink_to(REPO / "waternet_tpu_torch")
    return tmp_path


SMOKE = textwrap.dedent("""
    import json, sys
    from perfbench import harness
    cell = harness.Cell(sys.argv[1], overrides=json.loads(sys.argv[2]))
    line = harness.run_cell(cell, int(sys.argv[3]), 1.5, bool(int(sys.argv[4])), "cpu")
    print(json.dumps({"metrics": sorted(line["metrics"]), "numbers": line["_numbers"],
                      "forbidden": harness.forbidden_modules()}))
""")


def _smoke(cwd, name, overrides, trace=0):
    proc = subprocess.run([sys.executable, "-c", SMOKE, name, json.dumps(overrides), str(SEED), str(trace)],
                          cwd=cwd, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_new_cell_config_and_metric_are_files_alone(tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric, added as
    files and entries in a copy: found by name, no file edited."""
    root = _copy_bench(tmp_path)
    pb = root / "perfbench"
    cfg = json.loads((pb / "configs" / "can24.json").read_text())
    cfg.update(name="can16", width=16)
    (pb / "configs" / "can16.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "video_1080p.json").read_text())
    mix.update(height=36, width=48, frames_per_call=3)
    (pb / "traffic" / "video_tiny.json").write_text(json.dumps(mix))
    (pb / "workloads" / "can16.video_tiny.json").write_text(json.dumps(
        {"profile_seconds": 0.3, "check_calls": 1, "limits": {"mae_levels": 1.0}}))
    (pb / "metrics" / "frames_read.video.py").write_text(
        "def read(run):\n    return run.host.get('frames')\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "can16", "source": "https://arxiv.org/abs/1709.00643",
                             "file": "perfbench/configs/can16.json", "reduced": ["width"], "why": "test"})
    bench["workloads"].append({"name": "can16.video_tiny", "config": "can16", "traffic": "video_tiny",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "frames_per_s":
            m["workloads"].append("can16.video_tiny")
    bench["per_layer"].append({"name": "frames_read.video", "unit": "frames", "better": "higher",
                               "source": "host_clock", "layer": "engine: inference_engine.py",
                               "moves": "frames_per_s", "workloads": ["can16.video_tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = _smoke(root, "can16.video_tiny", {"mix.pool_calls": 2, "mix.warmup_calls": 1}, trace=1)
    assert "frames_read.video" in out["metrics"]
    assert out["numbers"]["mae_levels"] < 1.0
    assert out["forbidden"] == []


@pytest.mark.parametrize("name", sorted(TINY))
def test_runs_load_no_jax(tmp_path, name):
    """A CPU run of each cell, in a process of its own, holds no module whose
    top-level name is jax, jaxlib, flax or waternet_tpu (compared whole)."""
    out = _smoke(REPO, name, TINY[name])
    assert out["forbidden"] == []


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "waternet_tpu_torchx", sys)
    monkeypatch.setitem(sys.modules, "jaxlib_extra.mod", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "waternet_tpu.ops", sys)
    assert harness.forbidden_modules() == ["waternet_tpu.ops"]


def test_refuses_without_the_program(tmp_path):
    root = _copy_bench(tmp_path, with_program=False)
    proc = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", "waternet.video_1080p",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=root, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def test_seeds_beyond_32_bits():
    cell = harness.Cell("waternet.video_1080p")
    run = harness.Run(cell, 2 ** 31 + 12345, 1.0, False, "cpu")
    assert run.subseed("weights") != harness.Run(cell, 2 ** 31 + 12346, 1.0, False, "cpu").subseed("weights")
    assert 0 <= run.subseed("weights") < 2 ** 63
    torch.Generator().manual_seed(run.subseed("frames"))
