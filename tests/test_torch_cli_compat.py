"""The port's CLIs accept every flag of the JAX package's, and the last
small pieces of the JAX CLIs behave as there, on the CPU:

* every ``--flag`` the JAX CLIs define (read from their sources with
  ``ast``) is defined by the port's counterpart;
* ``train --tensorboard`` writes the JAX CLI's tags (``train/<k>``,
  ``val/<k>``, ``perf/images_per_sec``, step = epoch) through
  ``torch.utils.tensorboard``, read back with tensorboard's
  ``EventAccumulator``, each value the epoch's CSV value;
* ``score --epochs/--seed`` are accepted and ignored (a seed other than 0
  warns, as the JAX scorer does): the metrics are the same;
* ``python -m waternet_tpu_torch.export`` with ``tools/export_model.py``'s
  flags writes an artifact that runs as the eager model does;
* ``inference --download`` exits 2: the port fetches nothing.
"""

import ast
import json
import subprocess
import sys
import warnings
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
STUDENT = str(REPO / "tests" / "fixtures" / "distill" / "student.npz")
TEACHER = str(REPO / "tests" / "fixtures" / "distill" / "teacher.npz")

CLIS = [
    ("train.py", "waternet_tpu_torch/train.py"),
    ("inference.py", "waternet_tpu_torch/inference.py"),
    ("score.py", "waternet_tpu_torch/score.py"),
    ("bench.py", "waternet_tpu_torch/bench.py"),
    ("tools/export_model.py", "waternet_tpu_torch/export.py"),
    ("waternet_tpu/resilience/supervisor.py", "waternet_tpu_torch/resilience/supervisor.py"),
]


def _flags(path: str) -> set:
    tree = ast.parse((REPO / path).read_text())
    return {
        a.value
        for n in ast.walk(tree)
        if isinstance(n, ast.Call) and getattr(n.func, "attr", None) == "add_argument"
        for a in n.args
        if isinstance(a, ast.Constant) and isinstance(a.value, str) and a.value.startswith("--")
    }


@pytest.mark.parametrize("jax_cli,port_cli", CLIS, ids=[c[0] for c in CLIS])
def test_port_cli_accepts_every_jax_flag(jax_cli, port_cli):
    want = _flags(jax_cli)
    assert want, jax_cli
    assert sorted(want - _flags(port_cli)) == []


def test_train_tensorboard_writes_the_jax_tags(tmp_path):
    """Run with tensorflow hidden (as where the port runs without it):
    tensorboard then writes through its own stub, and the 13 s import of
    tensorflow is saved."""
    import os

    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    shadow = tmp_path / "shadow" / "tensorflow"
    shadow.mkdir(parents=True)
    (shadow / "__init__.py").write_text("raise ImportError('tensorflow is hidden from this run')\n")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(shadow.parent), str(REPO)])}
    proc = subprocess.run(
        [sys.executable, "-m", "waternet_tpu_torch.train", "--device", "cpu", "--synthetic", "16", "--epochs", "2",
         "--batch-size", "4", "--height", "32", "--width", "32", "--no-perceptual", "--precision", "fp32",
         "--workers", "0", "--tensorboard", "--train-root", str(tmp_path / "runs")],
        cwd=REPO, capture_output=True, text=True, timeout=600, env=env,
    )
    assert proc.returncode == 0, proc.stderr
    run = tmp_path / "runs" / "0"
    acc = EventAccumulator(str(run / "tb"))
    acc.Reload()
    tags = set(acc.Tags()["scalars"])
    names = ("mse", "ssim", "psnr", "perceptual_loss")
    assert {f"train/{k}" for k in (*names, "loss")} | {f"val/{k}" for k in names} | {"perf/images_per_sec"} <= tags
    csv = np.loadtxt(run / "metrics-train.csv", delimiter=",", skiprows=1, ndmin=2)
    header = (run / "metrics-train.csv").read_text().splitlines()[0].split(",")
    for k in ("mse", "psnr"):
        events = acc.Scalars(f"train/{k}")
        assert [e.step for e in events] == [0, 1]
        np.testing.assert_allclose([e.value for e in events], csv[:, header.index(k)], rtol=1e-5)


def test_score_accepts_and_ignores_epochs_and_seed(tmp_path):
    from waternet_tpu_torch import score

    raw = tmp_path / "raw"
    raw.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        cv2.imwrite(str(raw / f"{i}.png"), rng.integers(0, 256, (24, 32, 3), dtype=np.uint8))
    outs = []
    for extra in ([], ["--epochs", "7", "--seed", "0"], ["--epochs", "7", "--seed", "3"]):
        path = tmp_path / f"{len(outs)}.json"
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            score.main(["--weights", TEACHER, "--raw-dir", str(raw), "--device", "cpu", "--json-out", str(path),
                        *extra])
        seeded = [w for w in caught if issubclass(w.category, RuntimeWarning) and "--seed" in str(w.message)]
        assert len(seeded) == (1 if "3" in extra else 0)
        outs.append(json.loads(path.read_text()))
    assert outs[0] == outs[1] == outs[2]


def test_export_cli_writes_a_runnable_artifact(tmp_path, capsys):
    from waternet_tpu_torch import export
    from waternet_tpu_torch.hub import resolve_weights
    from waternet_tpu_torch.models.can import build_student, student_state_dict

    with pytest.raises(SystemExit, match="--arch can needs an explicit --weights"):
        export.main(["--arch", "can", "--device", "cpu"])
    assert export.main(["--weights", STUDENT, "--arch", "can", "--out", str(tmp_path / "student"),
                        "--device", "cpu"]) == 0
    assert "wrote float can artifact" in capsys.readouterr().out
    fn = export.load_artifact(tmp_path / "student.pt2")
    x = torch.from_numpy(np.random.default_rng(1).random((1, 24, 40, 3), dtype=np.float32))
    with torch.no_grad():
        want = build_student(student_state_dict(resolve_weights(STUDENT)), torch.device("cpu"), torch.float32)(x)
    torch.testing.assert_close(fn(x), want, rtol=0, atol=2e-5)


def test_inference_download_exits_2(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "waternet_tpu_torch.inference", "--source", str(tmp_path), "--download",
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 2 and "over the network" in proc.stderr
