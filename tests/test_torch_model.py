"""Port model and weights (waternet_tpu_torch.models / utils) against the
JAX package: parameter count, the fp32 forward on the committed trained
weights, the weight conversions, and the reference's state_dict keys."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from waternet_tpu.models import WaterNet as JaxWaterNet
from waternet_tpu.utils.checkpoint import export_weights
from waternet_tpu.utils.checkpoint import load_weights as jax_load_weights
from waternet_tpu_torch.hub import resolve_weights
from waternet_tpu_torch.models import WaterNet
from waternet_tpu_torch.utils.checkpoint import load_weights
from waternet_tpu_torch.utils.convert import jax_from_state_dict, state_dict_from_jax

TEACHER = str(Path(__file__).parent / "fixtures" / "distill" / "teacher.npz")

# The reference's conv layout, net.py:12-70: (in, out, kernel).
_CMG = [(12, 128, 7), (128, 128, 5), (128, 128, 3), (128, 64, 1),
        (64, 64, 7), (64, 64, 5), (64, 64, 3), (64, 3, 3)]
_REF = [(6, 32, 7), (32, 32, 5), (32, 3, 3)]


def _reference_state_dict(seed=0):
    """Random state_dict with the reference's exact keys and OIHW shapes."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for mod, spec in [("cmg", _CMG), ("wb_refiner", _REF),
                      ("ce_refiner", _REF), ("gc_refiner", _REF)]:
        for i, (cin, cout, k) in enumerate(spec):
            sd[f"{mod}.conv{i + 1}.weight"] = torch.randn((cout, cin, k, k), generator=g) * 0.05
            sd[f"{mod}.conv{i + 1}.bias"] = torch.randn((cout,), generator=g) * 0.05
    return sd


def test_param_count_matches_reference():
    assert sum(p.numel() for p in WaterNet().parameters()) == 1_090_668


def test_forward_matches_jax_on_teacher_weights():
    """fp32 forward on the committed trained weights at (2, 24, 40, 3):
    within atol=2e-5, the bound tests/test_convert.py holds the JAX model
    to against an independent torch forward (float sums in another order)."""
    params = jax_load_weights(TEACHER)
    model = WaterNet()
    model.load_state_dict(state_dict_from_jax(load_weights(TEACHER)), strict=True)
    model.eval()
    rng = np.random.default_rng(0)
    ims = [rng.random((2, 24, 40, 3)).astype(np.float32) for _ in range(4)]
    with torch.inference_mode():
        got = model(*(torch.from_numpy(a) for a in ims)).numpy()
    want = np.asarray(JaxWaterNet().apply(params, *(jnp.asarray(a) for a in ims)))
    assert got.shape == (2, 24, 40, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_state_dict_round_trip_is_exact():
    tree = load_weights(TEACHER)
    sd = state_dict_from_jax(tree)
    back = jax_from_state_dict(sd)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b) == 34
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    sd2 = state_dict_from_jax(back)
    assert sd2.keys() == sd.keys()
    for k in sd:
        assert torch.equal(sd2[k], sd[k])


def test_flat_npz_keys_convert_like_the_nested_tree():
    with np.load(TEACHER) as data:
        flat = {k: data[k] for k in data.files}
    a = state_dict_from_jax(flat)
    b = state_dict_from_jax(load_weights(TEACHER))
    for k in b:
        assert torch.equal(a[k], b[k])


def test_reference_state_dict_loads_strict(tmp_path):
    sd = _reference_state_dict()
    model = WaterNet()
    model.load_state_dict(sd, strict=True)
    assert set(model.state_dict()) == set(sd)
    pt = tmp_path / "waternet_exported_state_dict-abc.pt"
    torch.save(sd, pt)
    loaded = resolve_weights(pt)
    for k in sd:
        assert torch.equal(loaded[k], sd[k])


def test_reference_pt_and_jax_conversion_agree(tmp_path):
    """The same weights through both bridges: the reference .pt loaded by
    the port directly, and converted by the JAX package's torch_port into
    a JAX forward. Outputs agree to fp32 rounding."""
    from waternet_tpu.utils.torch_port import waternet_params_from_torch

    sd = _reference_state_dict(1)
    pt = tmp_path / "ref.pt"
    torch.save(sd, pt)
    model = WaterNet()
    model.load_state_dict(resolve_weights(pt), strict=True)
    rng = np.random.default_rng(1)
    ims = [rng.random((1, 16, 20, 3)).astype(np.float32) for _ in range(4)]
    with torch.inference_mode():
        got = model(*(torch.from_numpy(a) for a in ims)).numpy()
    want = np.asarray(
        JaxWaterNet().apply(waternet_params_from_torch(pt), *(jnp.asarray(a) for a in ims))
    )
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_npz_hash_in_filename_is_verified(tmp_path):
    path = export_weights(jax_load_weights(TEACHER), tmp_path)
    tree = load_weights(path)  # the embedded hash verifies
    assert "params" in tree
    path.write_bytes(path.read_bytes()[:-10] + b"corruption")
    with pytest.raises(ValueError, match="hash mismatch"):
        load_weights(path)


def test_resolve_weights_refuses_missing_and_unknown(tmp_path):
    with pytest.raises(FileNotFoundError):
        resolve_weights(tmp_path / "nope.npz")
    bad = tmp_path / "w.bin"
    bad.write_bytes(b"x")
    with pytest.raises(ValueError, match="unsupported suffix"):
        resolve_weights(bad)
