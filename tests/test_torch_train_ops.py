"""The training slice's building blocks against the JAX package, on the
CPU: data (shuffle, synthetic pairs), augmentation, the fused preprocess,
VGG19, the losses and metrics, and the weights file.

Tolerances, each with its reason:
* shuffle, synthetic pairs, augmentation: bit-identical (numpy streams;
  pure data movement under identical draws);
* ``fused_train_preprocess``: within one uint8 level (the float LAB
  inverse inside ``histeq``, the bound of tests/test_torch_ops.py);
* SSIM, PSNR, MSE: rel 1e-5 (float32 convolutions and means summed in
  other orders);
* VGG19 features: ``atol`` 1e-6 at a feature scale of ~1e-2 (relative
  1e-4; sixteen 3x3 float32 convolutions summed in other orders), and the
  perceptual loss rel 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from waternet_tpu.data import augment as jaug
from waternet_tpu.data.batching import epoch_permutation as jax_epoch_permutation
from waternet_tpu.data.synthetic import SyntheticPairs as JaxPairs
from waternet_tpu.data.synthetic import synthetic_split as jax_split
from waternet_tpu.models.vgg import VGG19Features as JaxVGG
from waternet_tpu.models.vgg import imagenet_normalize as jax_normalize
from waternet_tpu.models.vgg import init_vgg_params as jax_init_vgg
from waternet_tpu.ops.fused import fused_train_preprocess as jax_fused
from waternet_tpu.training import losses as jlosses
from waternet_tpu.training import metrics as jmetrics
from waternet_tpu_torch.data import augment
from waternet_tpu_torch.data.batching import epoch_permutation
from waternet_tpu_torch.data.synthetic import SyntheticPairs, synthetic_split
from waternet_tpu_torch.models.vgg import VGG19Features, features_state_dict, imagenet_normalize
from waternet_tpu_torch.ops.fused import fused_train_preprocess
from waternet_tpu_torch.training import losses, metrics
from waternet_tpu_torch.utils.convert import vgg_state_dict_from_jax


@pytest.fixture(scope="module")
def jax_vgg_params():
    return jax.tree.map(np.asarray, jax_init_vgg())


@pytest.fixture(scope="module")
def vgg(jax_vgg_params):
    m = VGG19Features()
    m.load_state_dict(vgg_state_dict_from_jax(jax_vgg_params))
    return m.eval().requires_grad_(False)


def _pairs(n, h, w, seed=0):
    ds = SyntheticPairs(n, h, w, seed=seed)
    raw, ref = zip(*(ds.load_pair(i) for i in range(n)))
    return np.stack(raw), np.stack(ref)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,epoch", [(0, 0), (0, 3), (7, 1)])
def test_epoch_permutation_matches_jax(seed, epoch):
    idx = np.arange(5, 61)
    np.testing.assert_array_equal(
        epoch_permutation(idx, seed, epoch), jax_epoch_permutation(idx, seed, epoch)
    )


@pytest.mark.parametrize("hw", [(32, 32), (37, 53)])
def test_synthetic_pairs_byte_identical_to_jax(hw):
    mine, theirs = SyntheticPairs(6, *hw, seed=3), JaxPairs(6, *hw, seed=3)
    for i in range(6):
        for a, b in zip(mine.load_pair(i), theirs.load_pair(i)):
            assert a.dtype == b.dtype == np.uint8 and a.tobytes() == b.tobytes()
    for n in (8, 16, 64, 1000):
        for got, want in zip(synthetic_split(n, 8), jax_split(n, 8)):
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Augmentation and the fused preprocess
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(12, 12), (10, 14)], ids=["square", "non-square"])
def test_apply_augment_batch_matches_jax_for_every_draw(hw):
    """All 16 (hflip, vflip, rotk) combinations, one per image."""
    combos = [(h, v, k) for h in (0, 1) for v in (0, 1) for k in range(4)]
    hflip, vflip, rotk = (np.array(c) for c in zip(*combos))
    imgs = np.random.default_rng(0).integers(0, 256, size=(16, *hw, 3)).astype(np.uint8)
    want = np.asarray(jaug.apply_augment_batch(
        jnp.asarray(imgs), jnp.asarray(hflip.astype(bool)), jnp.asarray(vflip.astype(bool)),
        jnp.asarray(rotk.astype(np.int32)),
    ))
    got = augment.apply_augment_batch(
        torch.from_numpy(imgs), torch.from_numpy(hflip.astype(bool)),
        torch.from_numpy(vflip.astype(bool)), torch.from_numpy(rotk.astype(np.int32)),
    )
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_draw_augment_reaches_all_eight_dihedral_variants():
    gen = torch.Generator().manual_seed(0)
    hflip, vflip, rotk = augment.draw_augment(gen, 512)
    assert hflip.dtype == vflip.dtype == torch.bool and rotk.dtype == torch.int32
    variants = jaug.dihedral_variant_index(
        jnp.asarray(hflip.numpy()), jnp.asarray(vflip.numpy()), jnp.asarray(rotk.numpy()),
        square=True,
    )
    assert set(np.asarray(variants).tolist()) == set(range(8))
    # RandomRotate90(p=0.5): about 5/8 of the draws keep k == 0.
    assert 0.5 < float((rotk == 0).double().mean()) < 0.75


def test_draw_augment_is_a_function_of_the_generator_seed():
    a = augment.draw_augment(torch.Generator().manual_seed(5), 8)
    b = augment.draw_augment(torch.Generator().manual_seed(5), 8)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_augment_pair_batch_applies_the_same_draws_to_both():
    raw, _ = _pairs(6, 16, 16)
    t = torch.from_numpy(raw)
    a, b = augment.augment_pair_batch(torch.Generator().manual_seed(1), t, t.clone())
    assert torch.equal(a, b)


@pytest.mark.parametrize("hw", [(32, 32), (37, 53)])
def test_fused_train_preprocess_matches_jax_within_one_level(hw):
    raw, ref = _pairs(3, *hw, seed=2)
    want = jax_fused(jnp.asarray(raw), jnp.asarray(ref), None, augment=False)
    got = fused_train_preprocess(torch.from_numpy(raw), torch.from_numpy(ref), None, augment=False)
    assert len(got) == 5
    for name, g, w in zip(("x", "wbn", "hen", "gcn", "refn"), got, want):
        diff = np.abs(g.numpy() * 255.0 - np.asarray(w) * 255.0)
        assert diff.max() <= 1.0 + 1e-3, name
        if name != "hen":  # only histeq carries the LAB inverse
            assert diff.max() <= 1e-3, name


def test_fused_train_preprocess_eval_ignores_augment():
    raw, ref = _pairs(2, 16, 16)
    a = fused_train_preprocess(torch.from_numpy(raw), torch.from_numpy(ref), None, augment=True)
    b = fused_train_preprocess(torch.from_numpy(raw), torch.from_numpy(ref), None, augment=False)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# Metrics and losses
# ---------------------------------------------------------------------------


def _out_ref(n=3, h=32, w=40, seed=0):
    rng = np.random.default_rng(seed)
    ref = rng.random((n, h, w, 3)).astype(np.float32)
    out = np.clip(ref + rng.normal(0, 0.1, ref.shape), 0, 1).astype(np.float32)
    return out, ref


@pytest.mark.parametrize("mask", [None, np.array([True, True, False])], ids=["unmasked", "masked"])
def test_ssim_psnr_match_jax(mask):
    out, ref = _out_ref()
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    for mine, theirs in (
        (metrics.ssim(torch.from_numpy(out), torch.from_numpy(ref), mask=tm),
         jmetrics.ssim(jnp.asarray(out), jnp.asarray(ref), mask=jm)),
        (metrics.psnr(torch.from_numpy(out), torch.from_numpy(ref), data_range=1.0, mask=tm),
         jmetrics.psnr(jnp.asarray(out), jnp.asarray(ref), data_range=1.0, mask=jm)),
    ):
        np.testing.assert_allclose(float(mine), float(theirs), rtol=1e-5)
    np.testing.assert_allclose(
        metrics.ssim_per_image(torch.from_numpy(out), torch.from_numpy(ref)).numpy(),
        np.asarray(jmetrics.ssim_per_image(jnp.asarray(out), jnp.asarray(ref))),
        rtol=1e-5,
    )


def test_ssim_data_range_is_taken_over_the_whole_batch():
    """One image with a wide range sets the constants for all: the per
    image SSIM of a narrow-range image depends on its batch mates."""
    out, ref = _out_ref(2)
    alone = metrics.ssim_per_image(torch.from_numpy(out[:1] * 0.5), torch.from_numpy(ref[:1] * 0.5))
    both = metrics.ssim_per_image(
        torch.from_numpy(np.concatenate([out[:1] * 0.5, out[1:]])),
        torch.from_numpy(np.concatenate([ref[:1] * 0.5, ref[1:]])),
    )
    assert float(alone[0]) != float(both[0])


@pytest.mark.parametrize("mask", [None, np.array([False, True, True])])
def test_mse_255_matches_jax(mask):
    out, ref = _out_ref(seed=1)
    got = losses.mse_255(torch.from_numpy(out), torch.from_numpy(ref),
                         None if mask is None else torch.from_numpy(mask))
    want = jlosses.mse_255(jnp.asarray(out), jnp.asarray(ref), None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert losses.PERCEPTUAL_WEIGHT == jlosses.PERCEPTUAL_WEIGHT


def test_vgg19_through_jax_weights_matches_jax(vgg, jax_vgg_params):
    x = np.random.default_rng(0).random((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(JaxVGG().apply(jax_vgg_params, jax_normalize(jnp.asarray(x))))
    got = vgg(imagenet_normalize(torch.from_numpy(x))).numpy()
    assert got.shape == want.shape == (2, 2, 2, 512) and got.dtype == np.float32
    assert np.abs(want).max() > 1e-3  # not a vacuous comparison
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_vgg_keys_are_torchvisions():
    """A full torchvision vgg19 state_dict (classifier too) loads through
    features_state_dict; the conv keys are features.{0,2,5,...,34}."""
    m = VGG19Features()
    keys = [k for k in m.state_dict() if k.endswith(".weight")]
    assert [int(k.split(".")[1]) for k in keys] == [
        0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32, 34,
    ]
    full = {f"features.{k.split('.', 1)[1]}": v for k, v in m.state_dict().items()}
    full["classifier.0.weight"] = torch.zeros(4, 4)
    m2 = VGG19Features()
    m2.load_state_dict(features_state_dict(full), strict=True)


@pytest.mark.parametrize("mask", [None, np.array([True, False])])
def test_perceptual_loss_matches_jax(vgg, jax_vgg_params, mask):
    out, ref = _out_ref(2, 32, 32, seed=4)
    got = losses.perceptual_loss(vgg, torch.from_numpy(out), torch.from_numpy(ref),
                                 None if mask is None else torch.from_numpy(mask))
    want = jlosses.perceptual_loss(JaxVGG(), jax_vgg_params, jnp.asarray(out), jnp.asarray(ref),
                                   None if mask is None else jnp.asarray(mask))
    assert float(want) > 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def test_save_weights_writes_the_jax_layout(tmp_path):
    from waternet_tpu.utils.checkpoint import load_weights as jax_load
    from waternet_tpu_torch.models import WaterNet
    from waternet_tpu_torch.utils.checkpoint import load_weights, save_weights
    from waternet_tpu_torch.utils.convert import state_dict_from_jax

    torch.manual_seed(0)
    sd = WaterNet().state_dict()
    path = save_weights(sd, tmp_path / "last.npz")
    with np.load(path) as f:
        assert "params/cmg/Conv_0/kernel" in f.files and f["params/cmg/Conv_0/kernel"].shape == (7, 7, 12, 128)
    for tree in (jax_load(path), load_weights(path)):
        back = state_dict_from_jax(tree)
        assert back.keys() == sd.keys()
        assert all(torch.equal(back[k], sd[k]) for k in sd)
    assert not list(tmp_path.glob(".*tmp*"))
