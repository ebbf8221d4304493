"""The port's inference CLI (``python -m waternet_tpu_torch.inference``) on
the CPU: video with ``--show-split`` (against the JAX CLI's
``run_video``), ``make_split`` against the JAX CLI's, directory decode
with ``--workers``, and ``--precision bf16``.

``make_split`` is pure numpy and cv2 in both packages: bit for bit. The
``video_ingest`` line must equal the JAX CLI's on the same clip, key for
key and value for value. Directory outputs must be byte-identical with
``--workers 0`` and ``--workers 2``: the batches and the forwards are the
same, only the decode moves to threads.
"""

import json
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

import inference as jax_cli
from waternet_tpu.inference_engine import InferenceEngine as JaxEngine
from waternet_tpu_torch import inference as cli

from test_torch_engine import TEACHER, frames

REPO = Path(__file__).resolve().parent.parent


def write_clip(path: Path, n: int, h: int, w: int, seed: int) -> None:
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter.fourcc(*"mp4v"), 5, (w, h))
    assert writer.isOpened()
    for f in frames((n, h, w, 3), seed):
        writer.write(np.ascontiguousarray(f))
    writer.release()


def read_clip(path: Path) -> list:
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f)
    cap.release()
    return out


def ingest_line(stdout: str) -> dict:
    (line,) = [ln for ln in stdout.splitlines() if ln.startswith('{"video_ingest"')]
    return json.loads(line)


def test_cli_video_show_split_writes_every_frame(tmp_path, capsys):
    src = tmp_path / "in.mp4"
    write_clip(src, 6, 48, 64, seed=3)
    out_root = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "waternet_tpu_torch.inference", "--device", "cpu", "--source", str(src),
         "--weights", TEACHER, "--show-split", "--batch-size", "3", "--output-root", str(out_root)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    written = read_clip(out_root / "0" / "in.mp4")
    assert len(written) == 6 and all(f.shape == (48, 64, 3) for f in written)

    # The JAX CLI's run_video on the same clip prints the same ingest line.
    jax_cli.run_video(JaxEngine(weights=TEACHER), src, tmp_path / "jax", True, 3, workers=2)
    want = ingest_line(capsys.readouterr().out)
    assert ingest_line(proc.stdout) == want
    assert want["video_ingest"]["frames_written"] == 6


def test_make_split_equals_jax():
    before, after = frames((2, 37, 101, 3), 9)
    got = cli.make_split(before, after)
    np.testing.assert_array_equal(got, jax_cli.make_split(before, after))
    assert got.dtype == np.uint8 and got.shape == before.shape
    np.testing.assert_array_equal(got[:, :10], before[:, :10])  # left of the label


def test_video_without_an_encoder_raises(tmp_path, monkeypatch):
    src = tmp_path / "in.mp4"
    write_clip(src, 2, 32, 48, seed=1)

    class NoEncoder:
        fourcc = staticmethod(cv2.VideoWriter.fourcc)

        def __init__(self, *args):
            pass

        def isOpened(self):
            return False

    monkeypatch.setattr(cv2, "VideoWriter", NoEncoder)
    with pytest.raises(RuntimeError, match="could not open any mp4 encoder"):
        cli.run_video(object(), src, tmp_path / "out", False, 2)


def _image_dir(root: Path) -> Path:
    src = root / "in"
    src.mkdir()
    for i, (h, w) in enumerate([(24, 32), (24, 32), (24, 32), (20, 28), (24, 32)]):
        cv2.imwrite(str(src / f"im{i}.png"), frames((1, h, w, 3), i)[0])
    (src / "broken.png").write_bytes(b"not a png")
    return src


def test_directory_outputs_identical_with_0_and_2_workers(tmp_path):
    src = _image_dir(tmp_path)
    outs = {}
    for workers in (0, 2):
        root = tmp_path / f"w{workers}"
        cli.main(["--source", str(src), "--weights", TEACHER, "--device", "cpu", "--batch-size", "2",
                  "--show-split", "--workers", str(workers), "--output-root", str(root)])
        outs[workers] = {p.name: p.read_bytes() for p in sorted((root / "0").glob("*.png"))}
    assert sorted(outs[0]) == [f"im{i}.png" for i in range(5)]
    assert outs[0] == outs[2]


def test_precision_bf16_runs_on_an_image(tmp_path, capsys):
    img = tmp_path / "one.png"
    cv2.imwrite(str(img), frames((1, 32, 48, 3), 4)[0])
    cli.main(["--source", str(img), "--weights", TEACHER, "--device", "cpu", "--precision", "bf16",
              "--device-preprocess", "--output-root", str(tmp_path / "out")])
    out = cv2.imread(str(tmp_path / "out" / "0" / "one.png"))
    assert out.shape == (32, 48, 3) and out.std() > 0
    assert "Saved 1 images" in capsys.readouterr().out
