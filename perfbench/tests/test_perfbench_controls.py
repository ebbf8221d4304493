"""The lower-precision controls: at a test's size on the CPU each reads
far above the program's own numbers; on the card, at the cell's own size
(marked ``card``), each comes out not correct."""

import json
import subprocess
import sys

import pytest

from perfbench import calibrate, harness
from perfbench.reference.compare import fp8_conv2d
from perfbench.tests.helpers import SEED, TINY


def _line(name, overrides=None):
    cell = harness.Cell(name, overrides=dict(TINY[name], **(overrides or {})))
    return harness.run_cell(cell, SEED, 1.5, False, "cpu")


@pytest.mark.parametrize("name", ["waternet.video_1080p", "can24.video_1080p", "waternet.serve_mixed_inproc"])
def test_int8_path_is_incorrect(name):
    """The program's own int8 path, the precision below the configuration's
    bfloat16, fails the cell's limits where the bfloat16 path passes."""
    extra = {"settings.check_requests": 6} if "serve" in name else {}
    assert _line(name, extra)["correct"] is True
    control = _line(name, dict(extra, **{"settings.quantize": True}))
    assert control["correct"] is False, control["checks"]


def test_fp8_reference_and_half_batch_are_incorrect():
    """The reference with float8 operands in the training program's place,
    and the reference trained on half of each batch, each fail a limit."""
    name = "waternet.train_fullres"
    assert _line(name)["correct"] is True
    cell = harness.Cell(name, overrides=TINY[name])
    limits = cell.settings["limits"]
    for numbers in (calibrate._train_readings(cell, SEED, conv=fp8_conv2d),
                    calibrate._train_readings(cell, SEED, half_batch=True)):
        assert any(numbers[k] > lim for k, lim in limits.items()), numbers


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(TINY))
def test_control_is_incorrect_on_the_card(card, name):
    """Three seeds of the control at the cell's own size fail its limits."""
    limits = harness.Cell(name).settings["limits"]
    proc = subprocess.run([sys.executable, "-m", "perfbench.calibrate", "--workload", name, "--control",
                           "--seeds", "3100000301,3100000302,3100000303", "--seconds", "4"],
                          cwd=harness.REPO, capture_output=True, text=True, timeout=1500)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for line in proc.stdout.splitlines():
        numbers = json.loads(line)["numbers"]
        assert any(numbers[k] > lim for k, lim in limits.items()), numbers
