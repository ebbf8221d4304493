"""The lint gate over the port (``python tools/lint_all.py
waternet_tpu_torch``): every rule family of the JAX package's linter
(``waternet_tpu/analysis``) run over ``waternet_tpu_torch/``.

The gate is zero unsuppressed findings. The port's deliberate patterns
carry written suppressions with their reasons, as the JAX package's do:
``OrderedPipeline._fifo`` is consumer-thread-only (R101), the
``gateway_hang`` fault wedges the server's event loop on purpose (R201),
and the serving engines' shape-key sets are first written in their
constructors, before any thread exists (R101).
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
