"""The port's deployment artifacts (waternet_tpu_torch/export.py): the
inference forward through ``torch.export`` with symbolic batch, height and
width, saved as ``.pt2`` and loaded back, on the CPU.

Bound: an artifact's output equals the eager forward of the same weights
on the same inputs, bit for bit (the exported graph runs the same
operators on the same device), at two shapes other than the one it was
traced at.
"""

from pathlib import Path

import pytest
import torch

from waternet_tpu_torch.export import export_forward, load_artifact, save_artifact
from waternet_tpu_torch.hub import build_model, resolve_weights
from waternet_tpu_torch.models import quant
from waternet_tpu_torch.models.can import build_student

FIXTURES = Path(__file__).parent / "fixtures" / "distill"
TEACHER = str(FIXTURES / "teacher.npz")
STUDENT = str(FIXTURES / "student.npz")
SHAPES = ((1, 37, 53, 3), (3, 20, 28, 3))


def _inputs(shape, n, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.rand(shape, generator=g) for _ in range(n)]


@pytest.fixture(scope="module")
def teacher():
    return resolve_weights(TEACHER)


@pytest.fixture(scope="module")
def student():
    return resolve_weights(STUDENT)


def test_waternet_artifact_roundtrip_at_two_shapes(teacher, tmp_path):
    path = save_artifact(tmp_path / "waternet", teacher, device="cpu")
    assert path.suffix == ".pt2" and path.is_file()
    run = load_artifact(path)
    model = build_model(teacher, "cpu")
    for i, shape in enumerate(SHAPES):
        xs = _inputs(shape, 4, i)
        out = run(*xs)
        with torch.inference_mode():
            want = model(*xs)
        assert out.shape == shape and out.dtype == torch.float32
        assert torch.equal(out, want)


def test_waternet_int8_artifact(teacher, tmp_path):
    calib = quant.default_calibration_inputs(n=2, hw=32)
    path = save_artifact(tmp_path / "q", teacher, quantize=True, calib_batches=calib, device="cpu")
    run = load_artifact(path)
    eager = quant.QuantWaterNet(quant.quantize_waternet(teacher, calib), "cpu")
    for i, shape in enumerate(SHAPES):
        xs = _inputs(shape, 4, 10 + i)
        assert torch.equal(run(*xs), eager(*xs))


@pytest.mark.parametrize("quantize", [False, True], ids=["float", "int8"])
def test_student_artifact_roundtrip(student, quantize, tmp_path):
    path = save_artifact(tmp_path / "student", student, arch="can", quantize=quantize, device="cpu")
    run = load_artifact(path)
    eager = (quant.QuantCAN(quant.quantize_can(student), "cpu") if quantize else build_student(student, "cpu"))
    for i, shape in enumerate(SHAPES + ((2, 70, 90, 3),)):
        (x,) = _inputs(shape, 1, 20 + i)
        with torch.inference_mode():
            want = eager(x)
        got = run(x)
        assert got.shape == shape and torch.equal(got, want)


def test_artifact_keeps_batch_height_and_width_symbolic(student):
    ep = export_forward(student, arch="can", device="cpu")
    (spec,) = [s for s in ep.graph_signature.input_specs if s.kind.name == "USER_INPUT"]
    shape = ep.graph_module.graph.find_nodes(op="placeholder", target=spec.arg.name)[0].meta["val"].shape
    assert all(isinstance(d, torch.SymInt) for d in shape[:3]) and shape[3] == 3


def test_calibration_without_quantize_is_rejected(teacher, tmp_path):
    with pytest.raises(ValueError, match="quantize=True"):
        save_artifact(tmp_path / "bad", teacher, calib_batches=quant.default_calibration_inputs(n=1, hw=16),
                      device="cpu")


def test_student_export_refuses_waternet_weights_and_unknown_arch(teacher, student, tmp_path):
    with pytest.raises(ValueError, match="quality-tier WaterNet weights"):
        save_artifact(tmp_path / "bad", teacher, arch="can", device="cpu")
    with pytest.raises(ValueError, match="arch must be"):
        save_artifact(tmp_path / "bad2", student, arch="resnet", device="cpu")


@pytest.mark.parametrize("arch", ["waternet", "can"])
def test_bf16_artifact_equals_the_autocast_forward(arch, teacher, student, tmp_path):
    from waternet_tpu_torch.hub import run_model

    params = teacher if arch == "waternet" else student
    run = load_artifact(save_artifact(tmp_path / arch, params, arch=arch, dtype=torch.bfloat16, device="cpu"))
    xs = _inputs((1, 30, 41, 3), 4 if arch == "waternet" else 1, 30)
    with torch.inference_mode():
        if arch == "waternet":
            want = run_model(build_model(teacher, "cpu"), torch.bfloat16, *xs)
        else:
            want = build_student(student, "cpu", torch.bfloat16)(*xs)
    got = run(*xs)
    assert got.dtype == torch.float32 and torch.equal(got, want)
