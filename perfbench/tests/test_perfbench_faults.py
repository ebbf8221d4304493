"""Runs of each cell with the timed path broken underneath (the card check
skipped): ``correct`` must come out false for each fault the cell can
have. And the cells at their own size on the card (marked ``card``)."""

import json
import subprocess
import sys

import pytest
import torch

from perfbench import arch as archs
from perfbench import harness
from perfbench.tests.helpers import SEED, TINY


def _run(name, seconds=0.6, overrides=None):
    cell = harness.Cell(name, overrides=dict(TINY[name], **(overrides or {})))
    return harness.run_cell(cell, SEED, seconds, False, "cpu")


def _wrap_engine(monkeypatch, config, method, broken):
    mod = archs.load(harness.load_json(harness.ROOT / "configs" / f"{config}.json"))
    real = mod.engine

    def engine(*a, **k):
        eng = real(*a, **k)
        setattr(eng, method, broken(getattr(eng, method)))
        return eng

    monkeypatch.setattr(mod, "engine", engine)


def _altered(fn):
    """An answer altered where it is produced: 10 levels brighter (the
    held tails start at 6 levels for WaterNet and 8 for CAN24)."""
    return lambda *a, **k: fn(*a, **k) + 10.0 / 255.0


def _half_batch(fn):
    """Half of the batch left out: its rows answered with the first row's."""
    def broken(*a, **k):
        out = fn(*a, **k).clone()
        n = len(a[0])
        out[n // 2:n] = out[0:1]
        return out
    return broken


@pytest.mark.parametrize("fault", [_altered, _half_batch])
@pytest.mark.parametrize("name,config", [("waternet.video_1080p", "waternet"), ("can24.video_1080p", "can24")])
def test_video_faults_are_incorrect(monkeypatch, name, config, fault):
    assert _run(name)["correct"] is True
    _wrap_engine(monkeypatch, config, "enhance_async", fault)
    assert _run(name)["correct"] is False


@pytest.mark.parametrize("fault", [_altered, _half_batch])
def test_serving_faults_are_incorrect(monkeypatch, fault):
    name = "waternet.serve_mixed_inproc"
    busy = {"mix.rate_per_s": 200.0, "settings.check_requests": 12}  # batches fill
    assert _run(name, 1.0, busy)["correct"] is True
    _wrap_engine(monkeypatch, "waternet", "enhance_padded_async", fault)
    assert _run(name, 1.0, busy)["correct"] is False


def test_training_state_left_unchanged_is_incorrect(monkeypatch):
    name = "waternet.train_fullres"
    assert _run(name)["correct"] is True
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    line = _run(name)
    assert line["correct"] is False and line["_numbers"]["change_gap"] == pytest.approx(1.0)


def test_training_half_batch_is_incorrect(monkeypatch):
    from waternet_tpu_torch.training.trainer import TrainingEngine

    real = TrainingEngine.train_step

    def half(self, raw_u8, ref_u8, generator, n_real, stamp=None):
        k = max(1, raw_u8.shape[0] // 2)
        return real(self, raw_u8[:k], ref_u8[:k], generator, min(n_real, k))

    monkeypatch.setattr(TrainingEngine, "train_step", half)
    assert _run("waternet.train_fullres")["correct"] is False


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(TINY))
def test_cell_on_the_card(card, name):
    """One short run of the cell as committed, on the card."""
    proc = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", name, "--seed", str(SEED),
                           "--seconds", "5", "--trace", "0"], cwd=harness.REPO, capture_output=True,
                          text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.splitlines()[-1])["correct"] is True
