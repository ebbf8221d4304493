"""The plain reference against OpenCV and against the port at small sizes,
one test per cell's path."""

import numpy as np
import pytest
import torch

from perfbench import arch as archs
from perfbench import harness
from perfbench.reference import codec, compare, nets, preprocess
from perfbench.reference import train as train_ref
from perfbench.traffic import images
from perfbench.tests.helpers import SEED, TINY


def _photo(h, w, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return images.frames(gen, 1, h, w, "cpu")[0]


@pytest.mark.parametrize("hw", [(37, 53), (64, 64), (120, 160)])
def test_transforms_match_opencv(hw):
    cv2 = pytest.importorskip("cv2")
    img = _photo(*hw).numpy()
    wb, gc, he = (t.numpy() for t in preprocess.transforms(torch.from_numpy(img)))
    flat = img.reshape(-1, 3).astype(np.float64)
    sums = flat.sum(0)
    sat = np.clip(0.005 * sums.max() / np.maximum(sums, 1), 0, 0.5)
    want_wb = np.empty_like(flat)
    for c in range(3):
        lo, hi = np.quantile(flat[:, c], [sat[c], 1 - sat[c]])
        v = np.clip(flat[:, c], lo, hi)
        want_wb[:, c] = (v - lo) * 255.0 / (hi - lo) if hi > lo else v
    assert np.array_equal(wb, want_wb.reshape(img.shape).astype(np.uint8))
    assert np.array_equal(gc, np.clip(255.0 * (img / 255.0) ** 0.7, 0, 255).astype(np.uint8))
    lab = cv2.cvtColor(img, cv2.COLOR_RGB2LAB)
    assert np.array_equal(preprocess.rgb_to_lab(torch.from_numpy(img)).numpy(), lab)
    lab[..., 0] = cv2.createCLAHE(clipLimit=0.1, tileGridSize=(8, 8)).apply(lab[..., 0])
    # The float inverse may round one level away from OpenCV's 8-bit one.
    assert np.abs(he - cv2.cvtColor(lab, cv2.COLOR_LAB2RGB)).max() <= 1


def test_dct8_roundtrip_matches_the_cache():
    from waternet_tpu_torch.data import codec as port_codec

    raw, _ = images.pairs(torch.Generator().manual_seed(5), 3, 45, 61, "cpu")
    u8 = raw.numpy()
    assert np.array_equal(codec.roundtrip(u8), port_codec.roundtrip("dct8", u8, "cpu"))


@pytest.mark.parametrize("config", ["waternet", "can24"])
def test_video_engine_against_reference(config):
    cfg = harness.load_json(harness.ROOT / "configs" / f"{config}.json")
    cfg = dict(cfg, precision="fp32")
    arch = archs.load(cfg)
    params = arch.make_params(cfg, torch.Generator().manual_seed(1), "cpu")
    frames = torch.stack([_photo(48, 64, s) for s in range(2)]).numpy()
    from waternet_tpu_torch.utils.tensor import ten2arr

    got = ten2arr(arch.engine(cfg, params, "cpu").enhance_async(frames))
    pairs = [(torch.from_numpy(got[i]), arch.reference(cfg, params, torch.from_numpy(frames[i])))
             for i in range(2)]
    numbers = compare.image_numbers(pairs)
    # float32 both sides: only the LAB inverse's rounding and the
    # truncation to uint8 separate them.
    assert numbers["mae_levels"] < 0.05 and numbers["max_levels"] <= 2


def test_serving_padded_against_reference():
    cfg = dict(harness.load_json(harness.ROOT / "configs" / "waternet.json"), precision="fp32")
    arch = archs.load(cfg)
    params = arch.make_params(cfg, torch.Generator().manual_seed(2), "cpu")
    imgs = [_photo(30, 41, 3).numpy(), _photo(25, 37, 4).numpy()]
    eng = arch.engine(cfg, params, "cpu")
    out = eng.enhance_padded(imgs, (31, 41), n_slots=4)
    pairs = [(torch.from_numpy(out[i, :im.shape[0], :im.shape[1]]),
              arch.reference_padded(cfg, params, im, (31, 41), "cpu")) for i, im in enumerate(imgs)]
    numbers = compare.image_numbers(pairs)
    assert numbers["mae_levels"] < 0.05 and numbers["max_levels"] <= 2


def test_training_steps_against_reference():
    cell = harness.Cell("waternet.train_fullres", overrides=dict(TINY["waternet.train_fullres"]))
    cell.config = dict(cell.config, precision="fp32")
    line = harness.run_cell(cell, SEED, 0.5, False, "cpu")
    n = line["_numbers"]
    assert n["loss1_gap"] < 1e-5 and n["grad_gap"] < 1e-3 and n["change_gap"] < 1e-2, n


def test_step_inputs_follow_the_epoch_order_and_draws():
    raw, ref = images.pairs(torch.Generator().manual_seed(7), 8, 16, 16, "cpu")
    x, wb, he, gc, r = train_ref.step_inputs(raw.numpy(), ref.numpy(), 11, 0, 1, 4, "cpu")
    rows = train_ref.epoch_order(8, 11, 0)[4:8]
    dec = codec.roundtrip(raw.numpy()[rows])
    h, v, k = train_ref.step_draws(11, 0, 1, 4)
    for i in range(4):
        want = train_ref.augment(dec[i], h[i], v[i], k[i])
        assert np.array_equal((x[i].permute(1, 2, 0) * 255).round().numpy().astype(np.uint8), want)


def test_reference_imports_nothing_of_the_program():
    import ast

    for path in (harness.ROOT / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in ("waternet_tpu_torch", "waternet_tpu", "jax", "jaxlib", "flax"), \
                    f"{path.name} imports {name}"


def test_vgg_layers_are_torchvisions():
    assert [i for i, _, _ in nets.vgg19_layers()] == [0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32, 34]
