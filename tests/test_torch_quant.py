"""The port's static int8 quantization (waternet_tpu_torch/models/quant.py)
against exact arithmetic and the JAX package's ``models/quant.py``.

* ``_conv_int8``'s int32 accumulators equal an exact reference (a float64
  convolution of the same codes: every product and sum is an integer below
  2^53) at every WaterNet and CAN layer shape, dilations included, in one
  band and in many;
* the weight codes equal JAX's exactly, each branch's first scale too,
  and the deeper scales within rel 1e-6 or the fp32 forward's own parity
  bound (atol 2e-5 on the activation whose absmax they are, / 127), on
  the same weights and calibration data;
* on JAX's own qtree, converted: the first layer's accumulators equal
  JAX's int8 conv, and the output within 60 dB PSNR of JAX's
  ``quant_forward``;
* the JAX package's own bounds, on the port against its float forward:
  > 38 dB calibrated and > 35 dB held out for WaterNet (JAX's random init
  at 48^2), > 30 dB and mean abs < 0.02 for the distilled student.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from jax import lax

from waternet_tpu.models import WaterNet as JaxWaterNet
from waternet_tpu.models import quant as jq
from waternet_tpu.utils.checkpoint import load_weights as jax_load_weights
from waternet_tpu_torch.hub import resolve_weights
from waternet_tpu_torch.inference_engine import InferenceEngine, StudentEngine
from waternet_tpu_torch.models import quant
from waternet_tpu_torch.models.can import can_dilations
from waternet_tpu_torch.models.waternet import _CMG_SPEC, _REFINER_SPEC
from waternet_tpu_torch.utils.convert import qtree_from_jax, state_dict_from_jax

FIXTURES = Path(__file__).parent / "fixtures" / "distill"
STUDENT = str(FIXTURES / "student.npz")
TEACHER = str(FIXTURES / "teacher.npz")
ATOL = 2e-5  # tests/test_convert.py:83, the fp32 forward's bound

# (cin, cout, k, dilation) of every distinct conv: WaterNet's trunk and
# refiners, then the default 24 x 7 student's stages and head.
WATERNET_LAYERS = sorted({(cin, cout, k, 1) for cin, cout, k in _CMG_SPEC + _REFINER_SPEC})
CAN_LAYERS = sorted({(3 if i == 0 else 24, 24, 3, d) for i, d in enumerate(can_dilations(7))} | {(24, 3, 1, 1)})


def _psnr(out, ref) -> float:
    err = float(((out - ref) ** 2).mean())
    peak = float(ref.abs().max()) or 1.0
    return 10 * np.log10(peak**2 / err)


def _layer(cin, cout, k, seed):
    g = torch.Generator().manual_seed(seed)
    return {"weight": torch.randn((cout, cin, k, k), generator=g) * 0.1, "bias": torch.randn((cout,), generator=g) * 0.1}


def _exact_acc(x, q, dilation):
    """int32 accumulators of the codes' convolution in float64: exact."""
    xq = torch.clamp(torch.round(x / q["s_in"]), -127, 127)
    k = q["wq"].shape[-1]
    y = F.conv2d(xq.permute(0, 3, 1, 2).double(), q["wq"].double(), padding=dilation * (k // 2), dilation=dilation)
    return y.permute(0, 2, 3, 1).to(torch.int32)


@pytest.mark.parametrize("cin,cout,k,d", WATERNET_LAYERS + CAN_LAYERS, ids=lambda v: str(v))
@pytest.mark.parametrize("budget", [None, 1], ids=["one band", "row bands"])
def test_conv_int8_accumulators_are_exact(cin, cout, k, d, budget, monkeypatch):
    if budget is not None:
        monkeypatch.setattr(quant, "IM2COL_BUDGET_BYTES", budget)  # one output row a band
    layer = _layer(cin, cout, k, seed=cin * 31 + cout + k + d)
    x = torch.from_numpy(np.random.default_rng(d).uniform(-1, 1, (2, 19, 23, cin)).astype(np.float32))
    stats = {"t/0": float(x.abs().max())}
    q = quant._quantize_layers([layer], stats, "t")[0]
    q["wt"] = quant.gemm_operand(q["wq"])
    got = {}
    out = quant._conv_int8(q, x, d, "t/0", hook=got.__setitem__)
    want = _exact_acc(x, q, d)
    assert got["t/0"].dtype == torch.int32 and torch.equal(got["t/0"], want)
    assert out.shape == (2, 19, 23, cout) and out.dtype == torch.float32
    assert torch.equal(out, want.to(torch.float32) * q["rescale"] + q["bias"])


def test_gemm_padding_for_int_mm():
    """K and Cout pad to multiples of 8 and a tiny batch to 17 rows (what
    cuBLASLt's int8 GEMM needs); the padding changes no result."""
    wq = torch.randint(-127, 128, (3, 12, 7, 7), dtype=torch.int8)
    wt = quant.gemm_operand(wq)
    assert wt.shape == (8, 592) and wt.dtype == torch.int8
    assert not wt[3:].any() and not wt[:, 588:].any()
    q = {"wq": wq, "wt": wt, "s_in": torch.tensor(0.01), "rescale": torch.ones(3), "bias": torch.zeros(3)}
    x = torch.rand(1, 2, 3, 12)  # 6 rows < 17
    got = {}
    quant._conv_int8(q, x, 1, "tiny", hook=got.__setitem__)
    assert torch.equal(got["tiny"], _exact_acc(x, q, 1))


def test_band_rows_fit_the_budget():
    assert quant.band_rows(4, 1080, 1920, 3200, budget=1 << 30) == 43
    assert quant.band_rows(4, 1080, 1920, 3200, budget=1) == 1
    assert quant.band_rows(1, 10, 10, 8, budget=1 << 30) == 10


@pytest.fixture(scope="module")
def jax_setup():
    """JAX's own test setup (tests/test_quant.py): WaterNet's random init at
    48^2 and 4 synthetic calibration frames; the port gets the same weights,
    converted, and the same arrays."""
    x0 = jnp.ones((1, 48, 48, 3)) * 0.5
    params = jax.tree_util.tree_map(np.asarray, JaxWaterNet().init(jax.random.PRNGKey(0), x0, x0, x0, x0))
    calib = jq.default_calibration_inputs(n=4, hw=48)
    return params, state_dict_from_jax(params), calib


def test_default_calibration_inputs_equal_jax():
    for got, want in zip(quant.default_calibration_inputs(n=2, hw=40)[0], jq.default_calibration_inputs(n=2, hw=40)[0]):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(quant.default_can_calibration_inputs(n=2, hw=24)[0],
                                  jq.default_can_calibration_inputs(n=2, hw=24)[0])


def _assert_qtrees_match(port, jax_tree):
    assert list(port) == list(jax_tree)
    for branch in port:
        for mine, theirs in zip(port[branch], jax_tree[branch], strict=True):
            wq = np.asarray(theirs["wq"]).transpose(3, 2, 0, 1)
            assert mine["wq"].dtype == torch.int8
            np.testing.assert_array_equal(mine["wq"].numpy(), wq)
            # A scale is an activation's absmax / 127: within rel 1e-6, or
            # within the fp32 forward's own parity bound (atol 2e-5, /127)
            # where oneDNN and XLA round a deep activation differently.
            np.testing.assert_allclose(float(mine["s_in"]), float(theirs["s_in"]), rtol=1e-6, atol=ATOL / 127)
            s_w = np.asarray(theirs["rescale"]) / np.float32(theirs["s_in"])
            np.testing.assert_allclose((mine["rescale"] / mine["s_in"]).numpy(), s_w, rtol=1e-6)
            np.testing.assert_array_equal(mine["bias"].numpy(), np.asarray(theirs["bias"]))
        # A branch's first conv reads the data itself: its scale is exact.
        assert float(port[branch][0]["s_in"]) == float(jax_tree[branch][0]["s_in"])


def test_waternet_codes_equal_jax_and_scales_within_1e6(jax_setup):
    params, sd, calib = jax_setup
    _assert_qtrees_match(quant.quantize_waternet(sd, calib), jq.quantize_waternet(params, calib))


def test_can_codes_equal_jax_and_scales_within_1e6():
    jparams = jax_load_weights(STUDENT)
    calib = jq.default_can_calibration_inputs(n=4, hw=24)
    _assert_qtrees_match(quant.quantize_can(resolve_weights(STUDENT), calib), jq.quantize_can(jparams, calib))


def test_on_jax_qtree_first_layer_accumulators_equal_and_output_within_60db(jax_setup):
    params, _, calib = jax_setup
    jtree = jq.quantize_waternet(params, calib)
    x, wb, he, gc = calib[0]
    # JAX's own int8 conv of its first layer (quant.py's _conv_int8, the
    # accumulators before the rescale).
    inp = jnp.concatenate([jnp.asarray(a) for a in (x, wb, he, gc)], axis=-1)
    q0 = jtree["cmg"][0]
    xq = jnp.clip(jnp.round(inp / q0["s_in"]), -127, 127).astype(jnp.int8)
    want = lax.conv_general_dilated(xq, q0["wq"], (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                    preferred_element_type=jnp.int32)
    got = {}
    out = quant.quant_forward(qtree_from_jax(jtree), *(torch.from_numpy(a) for a in calib[0]), acc_hook=got.__setitem__)
    np.testing.assert_array_equal(got["cmg/0"].numpy(), np.asarray(want))
    ref = np.array(jax.jit(jq.quant_forward)(jtree, *(jnp.asarray(a) for a in calib[0])))
    assert _psnr(out, torch.from_numpy(ref)) >= 60.0


def test_functional_float_topology_equals_the_module(jax_setup):
    _, sd, calib = jax_setup
    from waternet_tpu_torch.hub import build_model

    xs = [torch.from_numpy(a) for a in calib[0]]
    with torch.inference_mode():
        assert torch.equal(build_model(sd, "cpu")(*xs), quant.float_forward(sd, *xs))


def test_int8_within_jax_bound_calibrated(jax_setup):
    _, sd, calib = jax_setup
    xs = [torch.from_numpy(a) for a in calib[0]]
    out = quant.quant_forward(quant.quantize_waternet(sd, calib), *xs)
    assert out.dtype == torch.float32
    assert _psnr(out, quant.float_forward(sd, *xs)) > 38.0


def test_int8_within_jax_bound_held_out(jax_setup):
    _, sd, calib = jax_setup
    q = quant.quantize_waternet(sd, calib)
    xs = [torch.from_numpy(a) for a in jq.default_calibration_inputs(n=4, hw=48, seed=123)[0]]
    assert _psnr(quant.quant_forward(q, *xs), quant.float_forward(sd, *xs)) > 35.0


@pytest.fixture(scope="module")
def student_setup():
    """The committed distilled student and UIEB-style crops, as JAX's test."""
    from waternet_tpu_torch.data.synthetic import SyntheticPairs

    data = SyntheticPairs(8, 24, 24, seed=0)
    crops = np.stack([data.load_pair(i)[0] for i in range(8)])
    return resolve_weights(STUDENT), [crops[:4].astype(np.float32) / 255.0], crops[4:].astype(np.float32) / 255.0


def test_can_int8_within_jax_bound_on_held_out_crops(student_setup):
    sd, calib, held_out = student_setup
    x = torch.from_numpy(held_out)
    ref = quant.can_float_forward(sd, x)
    out = quant.can_quant_forward(quant.quantize_can(sd, calib), x)
    assert out.dtype == torch.float32
    assert _psnr(out, ref) > 30.0
    assert float((out - ref).abs().mean()) < 0.02


def test_quantize_is_deterministic(jax_setup, student_setup):
    _, sd, calib = jax_setup
    for q1, q2 in ((quant.quantize_waternet(sd, calib), quant.quantize_waternet(sd, calib)),
                   (quant.quantize_can(student_setup[0], student_setup[1]),
                    quant.quantize_can(student_setup[0], student_setup[1]))):
        for branch in q1:
            for a, b in zip(q1[branch], q2[branch]):
                assert all(torch.equal(a[k], b[k]) for k in ("wq", "s_in", "rescale", "bias"))


def test_calibration_scales_track_input_range(jax_setup):
    _, sd, _ = jax_setup
    rng = np.random.default_rng(0)
    batch = tuple(rng.random((2, 48, 48, 3), np.float32) for _ in range(4))
    small = quant.quantize_waternet(sd, [tuple(0.1 * b for b in batch)])
    big = quant.quantize_waternet(sd, [batch])
    np.testing.assert_allclose(float(big["cmg"][0]["s_in"]), 10 * float(small["cmg"][0]["s_in"]), rtol=1e-5)


def test_quantized_inference_engine_close_to_float(jax_setup):
    _, sd, calib = jax_setup
    frames = np.random.default_rng(0).integers(0, 256, (2, 48, 48, 3), dtype=np.uint8)
    out_f = InferenceEngine(params=sd, device_preprocess=True, device="cpu").enhance(frames)
    eng_q = InferenceEngine(params=sd, device_preprocess=True, device="cpu", quantize=True, calib_batches=calib)
    out_q = eng_q.enhance(frames)
    assert eng_q.quantized and out_q.shape == frames.shape and out_q.dtype == np.uint8
    assert np.mean(np.abs(out_q.astype(int) - out_f.astype(int))) < 2.0
    # A ready qtree is taken as is: the same answers.
    again = InferenceEngine(params=eng_q.params, device_preprocess=True, device="cpu", quantize=True)
    np.testing.assert_array_equal(again.enhance(frames), out_q)


def test_student_engine_int8_close_to_float(student_setup):
    sd, calib, held_out = student_setup
    frames = (held_out * 255.0).astype(np.uint8)
    out_f = StudentEngine(params=sd, device="cpu").enhance(frames)
    eng_q = StudentEngine(params=sd, quantize=True, calib_batches=calib, device="cpu")
    out_q = eng_q.enhance(frames)
    assert eng_q.quantized and out_q.shape == frames.shape and out_q.dtype == np.uint8
    assert np.mean(np.abs(out_q.astype(int) - out_f.astype(int))) < 2.0
    assert np.abs(out_q.astype(int) - out_f.astype(int)).max() <= 16


def test_engines_refuse_calibration_without_quantize(student_setup):
    with pytest.raises(ValueError, match="quantize=True"):
        StudentEngine(params=student_setup[0], calib_batches=student_setup[1], device="cpu")
    with pytest.raises(ValueError, match="quantize=True"):
        InferenceEngine(weights=TEACHER, calib_batches=[(np.zeros((1, 8, 8, 3), np.float32),) * 4], device="cpu")


def test_is_qtree():
    assert quant.is_qtree(quant.quantize_can(resolve_weights(STUDENT), [np.zeros((1, 8, 8, 3), np.float32)]))
    assert not quant.is_qtree(resolve_weights(STUDENT)) and not quant.is_qtree({})
