"""The port's CAN student (waternet_tpu_torch/models/can.py) against the JAX
package's: the dilation schedule and receptive radius, the FLOP helpers
(the >= 5x floor at 112^2, ~34x), config inference with its loud
mismatches, the weight conversion both ways, and the forward on the
committed distilled student (tests/fixtures/distill/student.npz, width 24,
depth 5) against JAX's ``CANStudent.apply`` and ``can_float_forward``
within atol 2e-5."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from waternet_tpu.models import CANStudent as JaxCANStudent
from waternet_tpu.models import can as jax_can
from waternet_tpu.models.quant import can_float_forward as jax_can_float_forward
from waternet_tpu.utils.checkpoint import load_weights as jax_load_weights
from waternet_tpu_torch.hub import resolve_weights, waternet_student
from waternet_tpu_torch.models import CANStudent
from waternet_tpu_torch.models.can import (
    DEFAULT_DEPTH,
    DEFAULT_WIDTH,
    build_student,
    can_config_from_params,
    can_dilations,
    can_forward_flops,
    can_receptive_radius,
    flops_ratio,
    teacher_pipeline_flops,
    train_flops_per_image,
)
from waternet_tpu_torch.models.waternet import waternet_forward_flops
from waternet_tpu_torch.utils.checkpoint import flatten, load_weights, save_weights
from waternet_tpu_torch.utils.convert import can_state_dict_from_jax, is_can_tree, jax_from_can_state_dict

FIXTURES = Path(__file__).parent / "fixtures" / "distill"
STUDENT = str(FIXTURES / "student.npz")
TEACHER = str(FIXTURES / "teacher.npz")
ATOL = 2e-5  # tests/test_convert.py:83, the fp32 forward's bound


@pytest.fixture(scope="module")
def fixture_inputs():
    rng = np.random.default_rng(0)
    return rng.random((2, 37, 53, 3)).astype(np.float32)


@pytest.mark.parametrize("depth", [2, 4, 5, 7, 9])
def test_dilations_and_radius_match_jax(depth):
    assert can_dilations(depth) == jax_can.can_dilations(depth)
    assert can_receptive_radius(depth) == jax_can.can_receptive_radius(depth)


def test_default_schedule_and_radius():
    assert (DEFAULT_WIDTH, DEFAULT_DEPTH) == (24, 7)
    assert can_dilations(DEFAULT_DEPTH) == [1, 2, 4, 8, 16, 32, 1]
    assert can_receptive_radius() == 64
    with pytest.raises(ValueError, match="depth must be >= 2"):
        can_dilations(1)


def test_flop_floor_and_ratio_at_112():
    """The >= 5x acceptance floor at 112^2 and the default's ~34x: 31,824
    student MACs a pixel against WaterNet's 1,089,824."""
    h = w = 112
    assert can_forward_flops(1, 1) == 2 * 31_824
    assert waternet_forward_flops(1, 1) == 2 * 1_089_824
    assert teacher_pipeline_flops(h, w) == waternet_forward_flops(h, w)
    ratio = flops_ratio(h, w)
    assert ratio >= 5.0 and ratio == pytest.approx(34.25, abs=0.01)
    assert ratio == pytest.approx(jax_can.flops_ratio(h, w))


@pytest.mark.parametrize("width,depth,distill", [(24, 7, False), (24, 7, True), (8, 4, True)])
def test_flop_helpers_equal_jax(width, depth, distill):
    for h, w in ((112, 112), (37, 53)):
        assert can_forward_flops(h, w, width, depth) == jax_can.can_forward_flops(h, w, width, depth)
        assert train_flops_per_image(h, w, width, depth, distill) == jax_can.train_flops_per_image(
            h, w, width, depth, distill)
    assert can_forward_flops(224, 224) == 4 * can_forward_flops(112, 112)


def test_state_dict_layout_and_param_count_match_jax():
    model = CANStudent()
    keys = list(model.state_dict())
    assert keys[0] == "layers.0.weight" and keys[-1] == f"layers.{DEFAULT_DEPTH}.bias"
    jparams = JaxCANStudent().init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3), jnp.float32))
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(jparams))
    assert sum(p.numel() for p in model.parameters()) == n_jax


def test_config_inference_on_fixture_and_both_layouts():
    sd = resolve_weights(STUDENT)
    assert can_config_from_params(sd) == (24, 5)
    assert can_config_from_params(jax_load_weights(STUDENT)) == (24, 5)
    assert can_config_from_params(flatten(jax_load_weights(STUDENT))) == (24, 5)
    assert can_config_from_params(CANStudent(8, 4).state_dict()) == (8, 4)


def test_config_inference_refuses_waternet_loudly():
    for tree in (resolve_weights(TEACHER), jax_load_weights(TEACHER)):
        with pytest.raises(ValueError, match="quality-tier WaterNet weights"):
            can_config_from_params(tree)


def test_config_inference_names_a_shape_mismatch():
    sd = CANStudent(8, 4).state_dict()
    sd["layers.2.weight"] = torch.zeros(8, 5, 3, 3)
    with pytest.raises(ValueError, match="layers.2.weight"):
        can_config_from_params(sd)
    with pytest.raises(ValueError, match="not a CAN"):
        can_config_from_params({"params": {"Dense_0": {"kernel": np.zeros((2, 2))}}})
    with pytest.raises(ValueError, match="empty or non-dict"):
        can_config_from_params({})


def test_weight_conversion_round_trip_is_exact(tmp_path):
    jparams = jax_load_weights(STUDENT)
    sd = can_state_dict_from_jax(jparams)
    back = jax_from_can_state_dict(sd)
    for i in range(6):
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(back["params"][f"Conv_{i}"][leaf], jparams["params"][f"Conv_{i}"][leaf])
    assert is_can_tree(jparams) and not is_can_tree(jax_load_weights(TEACHER))
    save_weights(sd, tmp_path / "s.npz")
    again = load_weights(tmp_path / "s.npz")
    for i in range(6):
        np.testing.assert_array_equal(again["params"][f"Conv_{i}"]["kernel"], jparams["params"][f"Conv_{i}"]["kernel"])


def test_fixture_student_forward_matches_jax(fixture_inputs):
    """The port's CANStudent on student.npz at 2 x 37x53 against JAX's
    ``CANStudent.apply`` and ``can_float_forward``: within atol 2e-5."""
    jparams = jax_load_weights(STUDENT)
    x = fixture_inputs
    want_apply = np.asarray(JaxCANStudent(width=24, depth=5).apply(jparams, jnp.asarray(x)))
    want_func = np.asarray(jax_can_float_forward(jparams, jnp.asarray(x)))
    model = build_student(resolve_weights(STUDENT), "cpu")
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == x.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want_apply, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, want_func, rtol=0, atol=ATOL)


def test_random_init_forward_matches_jax_on_converted_weights():
    """A JAX random init (the default 24 x 7, every dilation up to 32)
    converted into the port: the forward within atol 2e-5 at 1 x 70x90."""
    jparams = JaxCANStudent().init(jax.random.PRNGKey(3), jnp.zeros((1, 8, 8, 3), jnp.float32))
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    x = np.random.default_rng(1).random((1, 70, 90, 3)).astype(np.float32)
    want = np.asarray(JaxCANStudent().apply(jparams, jnp.asarray(x)))
    model = build_student(jparams, "cpu")
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_bf16_student_close_to_fp32(fixture_inputs):
    sd = resolve_weights(STUDENT)
    x = torch.from_numpy(fixture_inputs)
    with torch.inference_mode():
        out32 = build_student(sd, "cpu")(x)
        out16 = build_student(sd, "cpu", torch.bfloat16)(x)
    assert out16.dtype == torch.float32
    assert float((out32 - out16).abs().max()) < 0.05


def test_student_is_shape_polymorphic():
    model = CANStudent(8, 3).eval()
    for shape in ((1, 5, 7, 3), (3, 40, 24, 3)):
        with torch.inference_mode():
            assert model(torch.rand(shape)).shape == shape


def test_hub_student_triple(fixture_inputs):
    pre, post, model = waternet_student(STUDENT, device="cpu")
    u8 = (fixture_inputs[0] * 255).astype(np.uint8)
    x = pre(u8)
    assert x.shape == (1, 37, 53, 3) and x.dtype == torch.float32
    with torch.inference_mode():
        out = post(model(x))
    assert out.shape == (1, 37, 53, 3) and out.dtype == np.uint8
    with pytest.raises(FileNotFoundError, match="explicit student checkpoint"):
        waternet_student(None, device="cpu")
    with pytest.raises(ValueError, match="quality-tier"):
        waternet_student(TEACHER, device="cpu")
