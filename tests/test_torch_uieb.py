"""The port's UIEB loader (``waternet_tpu_torch.data.uieb``), its split
constant, the host batch iterator and the host augmentation, against the
JAX package, on the CPU. Everything here is exact: the same files, seeds
and RNG states give the same indices, pixels and draws."""

from pathlib import Path

import numpy as np
import pytest
import torch

from waternet_tpu.data import augment as jax_augment
from waternet_tpu.data import batching as jax_batching
from waternet_tpu.data import uieb as jax_uieb
from waternet_tpu.data._split_constants import TORCH_SEED0_PERM_890 as JAX_PERM_890
from waternet_tpu_torch.data import augment, batching, uieb
from waternet_tpu_torch.data._split_constants import TORCH_SEED0_PERM_890
from waternet_tpu_torch.data.synthetic import SyntheticPairs


def write_uieb_tree(root, n: int = 6, h: int = 40, w: int = 48, seed: int = 3) -> Path:
    """A UIEB-layout tree (``raw-890/`` and ``reference-890/``) of ``n``
    synthetic pairs written as PNGs with cv2; returns ``root``."""
    import cv2

    root = Path(root)
    ds = SyntheticPairs(n, h, w, seed=seed)
    for sub in ("raw-890", "reference-890"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    for i in range(n):
        for sub, img in zip(("raw-890", "reference-890"), ds.load_pair(i)):
            cv2.imwrite(str(root / sub / f"{i:03d}.png"), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    return root


def test_split_constant_equals_jax_and_a_live_torch_stream():
    assert TORCH_SEED0_PERM_890 == JAX_PERM_890
    g = torch.Generator()
    g.manual_seed(0)
    assert torch.randperm(890, generator=g).tolist() == list(TORCH_SEED0_PERM_890)


@pytest.mark.parametrize("n_total,n_val,seed", [(890, 90, 0), (12, 4, 0), (50, 10, 3)])
def test_reference_split_equals_jax(n_total, n_val, seed):
    got = uieb.reference_split(n_total, n_val=n_val, seed=seed)
    want = jax_uieb.reference_split(n_total, n_val=n_val, seed=seed)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert len(got[1]) == n_val and sorted(np.concatenate(got).tolist()) == list(range(n_total))


@pytest.mark.parametrize("size", [(32, 32), (None, None)], ids=["resized", "multiple-of-32"])
def test_load_pair_equals_jax(tmp_path, size):
    """Pairs written by cv2 at 40x48 read back resized to (height, width),
    or to the multiple of 32 below each side with no size given."""
    root = write_uieb_tree(tmp_path, n=4)
    h, w = size
    args = (root / "raw-890", root / "reference-890")
    got = uieb.UIEBDataset(*args, im_height=h, im_width=w)
    want = jax_uieb.UIEBDataset(*args, im_height=h, im_width=w)
    assert got.names == want.names and len(got) == 4
    for i in range(4):
        for g, w_ in zip(got.load_pair(i), want.load_pair(i)):
            assert g.dtype == np.uint8 and g.shape == (32, 32, 3) and np.array_equal(g, w_)
    assert got.load_pair(0) is got.load_pair(0)  # the RAM cache


def test_batches_equal_jax(tmp_path):
    root = write_uieb_tree(tmp_path, n=7)
    args = (root / "raw-890", root / "reference-890")
    got = uieb.UIEBDataset(*args, im_height=32, im_width=32)
    want = jax_uieb.UIEBDataset(*args, im_height=32, im_width=32)
    kw = dict(shuffle=True, seed=5, epoch=2)
    pairs = list(zip(got.batches(np.arange(7), 3, **kw), want.batches(np.arange(7), 3, **kw)))
    assert [g[0].shape[0] for g, _ in pairs] == [3, 3, 1]
    for g, w in pairs:
        assert np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])


def test_name_mismatch_raises(tmp_path):
    root = write_uieb_tree(tmp_path, n=3)
    (root / "reference-890" / "001.png").rename(root / "reference-890" / "x.png")
    with pytest.raises(ValueError, match="mismatch"):
        uieb.UIEBDataset(root / "raw-890", root / "reference-890")


def test_corrupt_png_is_quarantined(tmp_path):
    root = write_uieb_tree(tmp_path, n=4)
    (root / "raw-890" / "002.png").write_bytes(b"not a png")
    ds = uieb.UIEBDataset(root / "raw-890", root / "reference-890", im_height=32, im_width=32)
    with pytest.raises(uieb.CorruptPairError, match="002.png") as err:
        ds.load_pair(2)
    assert err.value.name == "002.png" and err.value.path == root / "raw-890" / "002.png"
    with pytest.warns(RuntimeWarning, match="quarantined 1/4"):
        clean = ds.prevalidate(np.arange(4))
    assert clean.tolist() == [0, 1, 3] and ds.quarantined == ["002.png"]
    with pytest.raises(ValueError, match="all 1 pairs failed"):
        ds.prevalidate([2])


def test_iter_batches_equals_jax():
    ds = SyntheticPairs(9, 16, 16)
    for kw in (dict(shuffle=True, seed=1, epoch=3), dict(shuffle=False), dict(drop_remainder=True)):
        got = list(batching.iter_batches(ds.load_pair, np.arange(9), 4, **kw))
        want = list(jax_batching.iter_batches(ds.load_pair, np.arange(9), 4, **kw))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])


@pytest.mark.parametrize("hw", [(16, 16), (12, 20)], ids=["square", "non-square"])
def test_host_augment_equals_jax(hw):
    """The same generator state gives the same flips and rotations, and
    ``advance_augment_rng`` leaves the stream where the augment left it."""
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, (8, *hw, 3), dtype=np.uint8)
    ref = rng.integers(0, 256, (8, *hw, 3), dtype=np.uint8)
    g, w, adv = (np.random.default_rng(9) for _ in range(3))
    got = augment.augment_pair_np(g, raw, ref)
    want = jax_augment.augment_pair_np(w, raw, ref)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert not np.array_equal(got[0], raw)
    augment.advance_augment_rng(adv, 8)
    assert adv.bit_generator.state == g.bit_generator.state == w.bit_generator.state
