"""The lint gate over the port (``python tools/lint_all.py
waternet_tpu_torch``): every rule family of the JAX package's linter
(``waternet_tpu/analysis``) run over ``waternet_tpu_torch/``.

The gate is zero unsuppressed findings. The port's deliberate patterns
carry written suppressions with their reasons, as the JAX package's do:
``OrderedPipeline._fifo`` is consumer-thread-only (R101), the
``gateway_hang`` fault wedges the server's event loop on purpose (R201),
and the serving engines' shape-key sets are first written in their
constructors, before any thread exists (R101).

The port's own analyzer (``python -m waternet_tpu_torch.analysis.lint_all``,
its R0xx family retargeted at PyTorch's hazards) runs over the port and
``chip_smoke.py`` under the same gate; its R003 suppressions are the
sentinel window's fetch, the first-call device tables, the plain tile
histogram and the smoke script's own checks and timings.
"""

import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def report():
    proc = subprocess.run(
        [sys.executable, "tools/lint_all.py", "waternet_tpu_torch", "--json"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    return proc.returncode, json.loads(proc.stdout)


def test_port_has_no_unsuppressed_finding(report):
    rc, doc = report
    unsuppressed = [f for f in doc["findings"] if not f["suppressed"]]
    assert rc == 0 and doc["summary"]["unsuppressed"] == 0, json.dumps(unsuppressed, indent=1)
    # The whole package is scanned, the stream and fleet modules included.
    assert doc["summary"]["files_scanned"] >= 78


@pytest.mark.parametrize("path,rule,count", [
    ("waternet_tpu_torch/data/pipeline.py", "R101", 3),
    ("waternet_tpu_torch/inference_engine.py", "R101", 3),
    ("waternet_tpu_torch/serving/server.py", "R201", 1),
])
def test_port_suppressions_are_the_written_ones(report, path, rule, count):
    """Each suppressed finding sits where a written reason is, and no file
    carries more suppressions than its deliberate patterns."""
    _, doc = report
    suppressed = Counter((f["path"], f["rule"]) for f in doc["findings"] if f["suppressed"])
    assert suppressed[(path, rule)] == count
    assert sum(suppressed.values()) == 7
    src = (REPO / path).read_text()
    assert src.count(f"# jaxlint: disable-next={rule} ") + src.count(f"# jaxlint: disable={rule} ") == count


# -- the port's own analyzer (waternet_tpu_torch/analysis) --------------------


@pytest.fixture(scope="module")
def port_report():
    proc = subprocess.run(
        [sys.executable, "-m", "waternet_tpu_torch.analysis.lint_all", "--json"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    return proc.returncode, json.loads(proc.stdout)


def test_port_analyzer_finds_nothing_unsuppressed(port_report):
    """``python -m waternet_tpu_torch.analysis.lint_all`` over its default
    targets, the port and ``chip_smoke.py``: every family runs, and every
    finding is a written suppression."""
    rc, doc = port_report
    unsuppressed = [f for f in doc["findings"] if not f["suppressed"]]
    assert rc == 0 and doc["summary"]["unsuppressed"] == 0, json.dumps(unsuppressed, indent=1)
    assert doc["summary"]["files_scanned"] >= 99
    assert set(doc["summary"]["families"]) == {"torchlint", "threadlint", "asynclint"}
    assert any(f["path"] == "chip_smoke.py" for f in doc["findings"])


#: Each file's suppressed findings under the port's analyzer, by rule. R003:
#: the sentinel window's fetch (trainer), the first-call tables copied once
#: per device or shape, the plain tile histogram, and the smoke script's
#: own checks and timings.
PORT_SUPPRESSIONS = [
    ("chip_smoke.py", "R003", 26),
    ("waternet_tpu_torch/data/codec.py", "R003", 1),
    ("waternet_tpu_torch/data/pipeline.py", "R101", 3),
    ("waternet_tpu_torch/inference_engine.py", "R101", 3),
    ("waternet_tpu_torch/models/vgg.py", "R003", 2),
    ("waternet_tpu_torch/ops/clahe.py", "R003", 1),
    ("waternet_tpu_torch/ops/color.py", "R003", 2),
    ("waternet_tpu_torch/ops/gamma.py", "R003", 1),
    ("waternet_tpu_torch/ops/kernels.py", "R003", 2),
    ("waternet_tpu_torch/serving/server.py", "R201", 1),
    ("waternet_tpu_torch/training/metrics.py", "R003", 1),
    ("waternet_tpu_torch/training/trainer.py", "R003", 1),
]


@pytest.mark.parametrize("path,rule,count", PORT_SUPPRESSIONS)
def test_port_analyzer_suppressions_are_the_written_ones(port_report, path, rule, count):
    """Each suppressed finding sits where a written reason is, and no file
    carries more suppressions than its deliberate patterns."""
    _, doc = port_report
    suppressed = Counter((f["path"], f["rule"]) for f in doc["findings"] if f["suppressed"])
    assert suppressed[(path, rule)] == count
    assert sum(suppressed.values()) == sum(c for _, _, c in PORT_SUPPRESSIONS)
    comments = [ln for ln in (REPO / path).read_text().split("\n")
                if f"# jaxlint: disable-next={rule} " in ln or f"# jaxlint: disable={rule} " in ln]
    assert len(comments) == count
    for ln in comments:  # a reason after the rule id
        assert len(ln.split(f"={rule} ", 1)[1].strip()) >= 20, ln
