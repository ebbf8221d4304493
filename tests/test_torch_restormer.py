"""The port's Restormer (``waternet_tpu_torch/models/restormer.py``) on the
CPU: held against its plain float32 reference (``models/restormer_plain.py``,
the published equations) on seeded weights at a small preset and at the
published widths; the official state_dict layout and parameter count; the
blocks' counter and spans; ``RestormerEngine`` on the raw path it shares
with the CAN student, and its refusals of tiling and padding; the hub and
the inference CLI's ``--arch restormer``."""

import types

import cv2
import numpy as np
import pytest
import torch

from waternet_tpu_torch import hub
from waternet_tpu_torch import inference as cli
from waternet_tpu_torch.inference_engine import GLOBAL_ATTENTION, RestormerEngine, StudentEngine
from waternet_tpu_torch.models import Restormer
from waternet_tpu_torch.models import restormer as rmod
from waternet_tpu_torch.models import restormer_plain as plain
from waternet_tpu_torch.obs import stages, trace
from waternet_tpu_torch.utils.tensor import ten2arr

SMALL = {"dim": 8, "num_blocks": (1, 1, 1, 1), "num_refinement_blocks": 1, "heads": (1, 2, 4, 8)}
PUBLISHED = {"dim": 48, "num_blocks": (4, 6, 6, 8), "num_refinement_blocks": 4, "heads": (1, 2, 4, 8)}
#: Float32 on both sides. The port reorders the attention's products (the
#: Gram map of the raw q and k over their norms; A and the output
#: projection folded into one matrix), which moves only the last bits: the
#: largest gap seen is under 1e-6 on outputs of order 1.
ATOL = 1e-5


def seeded(cfg, seed):
    """A state_dict of ``Restormer(**cfg)``: torch's default init under
    ``seed``, the LayerNorm affines and the temperatures moved off 1 and 0
    by up to 0.1, so a dropped or swapped affine term shows."""
    gen = torch.Generator().manual_seed(seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        sd = Restormer(**cfg).state_dict()
    for k, v in sd.items():
        if ".norm" in k or k.endswith("temperature"):
            v.add_(torch.rand(v.shape, generator=gen) * 0.2 - 0.1)
    return sd


def reference(sd, cfg, x):
    """The plain reference on an NHWC batch, NHWC out."""
    return plain.restormer(sd, dict(cfg, ffn_expansion_factor=2.66), x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


@pytest.fixture(scope="module")
def published():
    return seeded(PUBLISHED, 1)


def official_layout(cfg):
    """{name: shape} of the official model's state_dict, written out from
    ``restormer_arch.py``'s module tree, independently of the port."""
    d, nb, hd = cfg["dim"], cfg["num_blocks"], cfg["heads"]
    out = {"patch_embed.proj.weight": (d, 3, 3, 3), "output.weight": (3, 2 * d, 3, 3)}
    groups = [("encoder_level1", nb[0], d, hd[0]), ("encoder_level2", nb[1], 2 * d, hd[1]),
              ("encoder_level3", nb[2], 4 * d, hd[2]), ("latent", nb[3], 8 * d, hd[3]),
              ("decoder_level3", nb[2], 4 * d, hd[2]), ("decoder_level2", nb[1], 2 * d, hd[1]),
              ("decoder_level1", nb[0], 2 * d, hd[0]), ("refinement", cfg["num_refinement_blocks"], 2 * d, hd[0])]
    for name, n, c, heads in groups:
        h = int(c * 2.66)
        for i in range(n):
            p = f"{name}.{i}"
            for norm in ("norm1", "norm2"):
                out[f"{p}.{norm}.body.weight"] = out[f"{p}.{norm}.body.bias"] = (c,)
            out[f"{p}.attn.temperature"] = (heads, 1, 1)
            out[f"{p}.attn.qkv.weight"] = (3 * c, c, 1, 1)
            out[f"{p}.attn.qkv_dwconv.weight"] = (3 * c, 1, 3, 3)
            out[f"{p}.attn.project_out.weight"] = (c, c, 1, 1)
            out[f"{p}.ffn.project_in.weight"] = (2 * h, c, 1, 1)
            out[f"{p}.ffn.dwconv.weight"] = (2 * h, 1, 3, 3)
            out[f"{p}.ffn.project_out.weight"] = (c, h, 1, 1)
    for name, cin, cout in (("down1_2", d, d // 2), ("down2_3", 2 * d, d), ("down3_4", 4 * d, 2 * d),
                            ("up4_3", 8 * d, 16 * d), ("up3_2", 4 * d, 8 * d), ("up2_1", 2 * d, 4 * d)):
        out[f"{name}.body.0.weight"] = (cout, cin, 3, 3)
    out["reduce_chan_level3.weight"] = (4 * d, 8 * d, 1, 1)
    out["reduce_chan_level2.weight"] = (2 * d, 4 * d, 1, 1)
    return out


@pytest.mark.parametrize("hw", [(32, 48), (40, 40), (37, 45)])
def test_small_preset_matches_plain_reference(hw):
    """Two frames at the small preset; 37x45 is reflect-padded to 40x48
    and cropped back on both sides."""
    sd = seeded(SMALL, 0)
    x = torch.rand((2, *hw, 3), generator=torch.Generator().manual_seed(hw[0]))
    with torch.no_grad():
        got = rmod.build_restormer(sd, "cpu")(x)
    assert got.shape == x.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, reference(sd, SMALL, x), atol=ATOL, rtol=0)


def test_published_widths_match_plain_reference(published):
    x = torch.rand((1, 32, 32, 3), generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        got = rmod.build_restormer(published, "cpu")(x)
    torch.testing.assert_close(got, reference(published, PUBLISHED, x), atol=ATOL, rtol=0)


def test_bf16_runs_close_to_fp32(published):
    """bf16 autocast over fp32 parameters: float32 out, within bf16's
    rounding of the fp32 forward."""
    x = torch.rand((1, 32, 32, 3), generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        fp32 = rmod.build_restormer(published, "cpu")(x)
        bf16 = rmod.build_restormer(published, "cpu", torch.bfloat16)(x)
    assert bf16.dtype == torch.float32
    assert (bf16 - fp32).abs().mean() < 0.01


def test_official_layout_loads_strictly(published):
    """The port's state_dict is the official one, name for name and shape
    for shape; a checkpoint wrapped under ``params`` (basicsr's) loads
    strictly; 26,126,644 parameters at the published configuration."""
    want = official_layout(PUBLISHED)
    assert {k: tuple(v.shape) for k, v in published.items()} == want
    assert sum(np.prod(s) for s in want.values()) == 26_126_644
    model = rmod.build_restormer({"params": published}, "cpu")
    assert sum(p.numel() for p in model.parameters()) == 26_126_644
    assert rmod.restormer_config_from_params(published) == PUBLISHED


def test_config_inference_names_what_does_not_fit():
    sd = seeded(SMALL, 2)
    sd.pop("latent.0.ffn.dwconv.weight")
    with pytest.raises(ValueError, match="latent.0.ffn.dwconv.weight"):
        rmod.restormer_config_from_params(sd)
    with pytest.raises(ValueError, match="official layout"):
        rmod.restormer_config_from_params({"layers.0.weight": torch.zeros(1)})


def test_pixel_shuffles_equal_torchs():
    x = torch.rand((2, 8, 10, 12), generator=torch.Generator().manual_seed(3))
    nhwc = x.permute(0, 2, 3, 1)
    assert torch.equal(rmod._pixel_unshuffle(nhwc), torch.nn.functional.pixel_unshuffle(x, 2).permute(0, 2, 3, 1))
    assert torch.equal(rmod._pixel_shuffle(nhwc), torch.nn.functional.pixel_shuffle(x, 2).permute(0, 2, 3, 1))


class FakeEvent:
    def __init__(self):
        self.t = 0.0

    def query(self):
        return True

    def elapsed_time(self, other):
        return 1.5


def test_blocks_count_and_record_their_halves(published, monkeypatch):
    """44 ``mdta`` and 44 ``gdfn`` block halves a forward, armed or not.
    Disarmed: no span, no timing event, no clock read. Armed: one span of
    each half per block, with ``frames`` and ``level`` (12 blocks at each
    of levels 1-3, 8 at 4) and, with timing events, ``device_ms``."""
    model = rmod.build_restormer(published, "cpu")
    x = torch.rand((2, 16, 16, 3), generator=torch.Generator().manual_seed(7))
    made = []
    monkeypatch.setattr(stages, "device_event", lambda device: made.append(1) or FakeEvent())
    monkeypatch.setattr(stages, "time", types.SimpleNamespace(perf_counter=lambda: made.append(1) or 0.0))
    rec = trace.recorder()
    rec.disable()
    rec.reset()
    rmod.reset_block_runs()
    with torch.no_grad():
        off = model(x)
    assert rmod.BLOCK_RUNS == {"mdta": 44, "gdfn": 44}
    assert made == [] and rec.snapshot()[0] == []
    rec.enable()
    try:
        with torch.no_grad():
            on = model(x)
        spans = [e for e in rec.snapshot()[0] if e[1] == rmod.CAT]
    finally:
        rec.disable()
        rec.reset()
    assert rmod.BLOCK_RUNS == {"mdta": 88, "gdfn": 88}
    assert torch.equal(on, off)
    for name in ("model.mdta", "model.gdfn"):
        args = [e[6] for e in spans if e[0] == name and e[2] == "X"]
        assert len(args) == 44
        assert all(a["frames"] == 2 and a["device_ms"] == 1.5 for a in args)
        assert sorted(a["level"] for a in args) == [1] * 12 + [2] * 12 + [3] * 12 + [4] * 8


def test_engine_matches_plain_reference_in_uint8():
    sd = seeded(SMALL, 3)
    frames = np.random.default_rng(0).integers(0, 256, (2, 24, 40, 3), dtype=np.uint8)
    got = RestormerEngine(params=sd, device="cpu").enhance(frames)
    x = torch.from_numpy(frames).float() / 255.0
    want = (reference(sd, SMALL, x).clamp(0, 1) * 255).to(torch.uint8).numpy()
    assert got.dtype == np.uint8 and got.shape == frames.shape
    assert np.abs(got.astype(int) - want).max() <= 1


def test_raw_engines_share_one_native_path():
    """The CAN student and Restormer run the one raw path (uint8 -> /255
    -> model, with its spans); neither keeps a copy of its own."""
    assert StudentEngine.enhance_async is RestormerEngine.enhance_async
    assert StudentEngine._fused is RestormerEngine._fused
    assert "enhance_async" not in vars(StudentEngine) and "enhance_async" not in vars(RestormerEngine)


def test_engine_refuses_tiling_and_padding():
    """Global attention: a frame split into halo tiles or padded to a
    bucket gives another result, so the engine refuses both, naming why."""
    sd = seeded(SMALL, 4)
    with pytest.raises(ValueError, match="global"):
        RestormerEngine(params=sd, device="cpu", spatial_shards=2)
    eng = RestormerEngine(params=sd, device="cpu")
    img = np.zeros((20, 30, 3), np.uint8)
    for call in (lambda: eng.enhance_padded([img], (24, 32)), lambda: eng.enhance_padded_async([img], (24, 32)),
                 lambda: eng.warm_padded(2, (24, 32)), lambda: eng.pad_raw_to_bucket([img], (24, 32))):
        with pytest.raises(ValueError, match="global") as err:
            call()
        assert str(err.value) == GLOBAL_ATTENTION
    with pytest.raises(FileNotFoundError, match="explicit weights"):
        RestormerEngine(device="cpu")


def test_hub_and_cli_load_an_official_checkpoint(tmp_path):
    """A ``.pth`` in basicsr's layout (under ``params``) through
    ``hub.restormer`` and through the CLI's image, directory and video
    modes; the CLI refuses the options a whole-frame model cannot take."""
    sd = seeded(SMALL, 5)
    path = tmp_path / "restormer.pth"
    torch.save({"params": sd}, path)
    rgb = np.random.default_rng(1).integers(0, 256, (24, 40, 3), dtype=np.uint8)
    pre, post, model = hub.restormer(weights=path, device="cpu")
    with torch.no_grad():
        via_hub = post(model(pre(rgb)))[0]
    engine = RestormerEngine(weights=path, device="cpu")
    assert np.array_equal(via_hub, engine.enhance(rgb[None])[0])

    src = tmp_path / "src"
    src.mkdir()
    for i, (h, w) in enumerate([(24, 40), (24, 40), (16, 24)]):
        cv2.imwrite(str(src / f"{i}.png"), np.random.default_rng(i).integers(0, 256, (h, w, 3), dtype=np.uint8))
    clip = src / "clip.mp4"
    writer = cv2.VideoWriter(str(clip), cv2.VideoWriter.fourcc(*"mp4v"), 5, (40, 24))
    for i in range(3):
        writer.write(np.random.default_rng(10 + i).integers(0, 256, (24, 40, 3), dtype=np.uint8))
    writer.release()
    out = tmp_path / "out"
    cli.main(["--source", str(src), "--arch", "restormer", "--restormer-weights", str(path), "--device", "cpu",
              "--output-root", str(out), "--workers", "0"])
    for i in range(3):
        bgr = cv2.imread(str(src / f"{i}.png"))
        want = engine.enhance(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)[None])[0]
        assert np.array_equal(cv2.imread(str(out / "0" / f"{i}.png")), cv2.cvtColor(want, cv2.COLOR_RGB2BGR))
    cap = cv2.VideoCapture(str(out / "0" / "clip.mp4"))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == 3
    for bad in (["--tier", "fast"], ["--spatial-shards", "2"], ["--quantize"], ["--device-preprocess"]):
        with pytest.raises(SystemExit):
            cli.parse_args(["--source", str(src), "--arch", "restormer", "--restormer-weights", str(path), *bad])
    with pytest.raises(SystemExit):
        cli.parse_args(["--source", str(src), "--arch", "restormer"])
    with pytest.raises(SystemExit):
        cli.parse_args(["--source", str(src), "--restormer-weights", str(path)])


def test_engine_readback_is_the_frames_shape(published):
    """The published widths through the engine in bf16: uint8 frames of the
    input's shape, read back with ``ten2arr``."""
    frames = np.random.default_rng(2).integers(0, 256, (1, 16, 24, 3), dtype=np.uint8)
    out = ten2arr(RestormerEngine(params=published, dtype=torch.bfloat16, device="cpu").enhance_async(frames))
    assert out.shape == frames.shape and out.dtype == np.uint8
