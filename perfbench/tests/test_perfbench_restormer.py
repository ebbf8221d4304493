"""The cell ``restormer.video_1080p``: found by name, its readers, its FLOP
count against a layer-by-layer sum, its reference against the program's
plain reference, and a CPU run that loads nothing of JAX."""

import pytest
import torch

from perfbench import arch as archs
from perfbench import harness
from perfbench.counts import restormer as counts
from perfbench.reference import restormer as ref
from perfbench.tests.test_perfbench_harness import _smoke

CELL = "restormer.video_1080p"
TINY = {"mix.height": 40, "mix.width": 56, "mix.frames_per_call": 2, "mix.pool_calls": 2, "mix.warmup_calls": 1,
        "settings.profile_seconds": 0.3}
SMALL = {"dim": 8, "num_blocks": [1, 1, 1, 1], "num_refinement_blocks": 1, "heads": [1, 2, 4, 8]}
METRICS = ("mdta_device_ms_per_frame.restormer", "gdfn_device_ms_per_frame.restormer",
           "forward_device_ms_per_frame.restormer", "mfu.restormer", "device_idle_pct.restormer")
SEED = 2 ** 31 + 977


def _config(**small):
    return dict(harness.load_json(harness.ROOT / "configs" / "restormer.json"), **small)


def test_cell_resolves_by_name():
    cell = harness.Cell(CELL)
    assert cell.chips == 1 and cell.config["arch"] == "restormer" and cell.config["reduced"] == []
    assert cell.mix == harness.load_json(harness.ROOT / "traffic" / "video_1080p.json")
    assert {m["name"] for m in cell.end_to_end} == {"frames_per_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == set(METRICS)
    assert cell.settings["check_calls"] == 2 and cell.settings["profile_seconds"] == 2
    assert all(k.startswith("off") or k == "mae_levels" for k in cell.settings["limits"])


def _span(name, args):
    return (name, "engine", "X", 0.0, 0.01, 1, args)


@pytest.mark.parametrize("metric", METRICS)
def test_readers_give_none_without_the_programs_spans(metric):
    """A program without the blocks' spans, or whose spans carry no device
    time, and a run with no profile and no card, leave each metric out."""
    run = harness.Run(harness.Cell(CELL, overrides=TINY), SEED, 1.0, True, "cpu")
    for spans in ([_span("enhance_async", {}), _span("ten2arr", {})],
                  [_span(n, {"frames": 4, "level": 1}) for n in ("engine.forward", "model.mdta", "model.gdfn")]):
        run.spans = spans
        assert harness.read_metric(run, metric) is None


def test_block_readers_give_the_blocks_ms_a_frame():
    """Σ device_ms / Σ frames of a half's spans, times the 44 blocks."""
    run = harness.Run(harness.Cell(CELL, overrides=TINY), SEED, 1.0, True, "cpu")
    run.spans = ([_span("model.mdta", {"frames": 4, "level": 1, "device_ms": 8.0})] * 44
                 + [_span("model.gdfn", {"frames": 4, "level": 2, "device_ms": 12.0})] * 44
                 + [_span("engine.forward", {"frames": 4, "device_ms": 1000.0})])
    assert harness.read_metric(run, METRICS[0]) == pytest.approx(88.0)
    assert harness.read_metric(run, METRICS[1]) == pytest.approx(132.0)
    assert harness.read_metric(run, METRICS[2]) == pytest.approx(250.0)


def _counted(cfg, h, w):
    """FLOPs of the reference's forward, summed over every call of its conv
    hook: 2 per multiply-add of each convolution and attention product."""
    total = 0

    def conv(x, wt, b=None, padding=0, groups=1):
        nonlocal total
        out = ref.conv2d(x, wt, b, padding, groups)
        total += 2 * out.numel() * wt.shape[1] * wt.shape[2] * wt.shape[3]
        return out

    params = archs.load(cfg).make_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ref.restormer(params, cfg, torch.rand(1, 3, h, w), conv)
    return total


@pytest.mark.parametrize("small,hw", [(SMALL, (40, 56)), (SMALL, (37, 45)), ({}, (16, 24))])
def test_flop_count_is_the_layer_by_layer_sum(small, hw):
    cfg = _config(**small)
    assert counts.forward(cfg, *hw) == _counted(cfg, *hw)


def test_published_flops_a_pixel():
    per_pixel = counts.forward(_config(), 1080, 1920) / (1080 * 1920)
    assert per_pixel == pytest.approx(2 * 2.363e6, rel=0.005)


def test_benchmark_reference_equals_the_programs_plain_reference():
    from waternet_tpu_torch.models import restormer_plain

    cfg = _config(**SMALL)
    params = archs.load(cfg).make_params(cfg, torch.Generator().manual_seed(1), "cpu")
    x = torch.rand((2, 3, 37, 45), generator=torch.Generator().manual_seed(2))
    assert torch.equal(ref.restormer(params, cfg, x), restormer_plain.restormer(params, cfg, x))


def test_seeded_weights_load_into_the_program():
    """The draw's leaves are the official layout, strictly loadable, and
    the affine terms are off 1 and 0."""
    from waternet_tpu_torch.models.restormer import build_restormer

    cfg = _config(**SMALL)
    params = archs.load(cfg).make_params(cfg, torch.Generator().manual_seed(3), "cpu")
    build_restormer(params, "cpu")
    w, b = params["latent.0.norm1.body.weight"], params["latent.0.norm1.body.bias"]
    assert 0.9 <= w.min() < w.max() <= 1.1 and w.ne(1).all() and -0.1 <= b.min() < b.max() <= 0.1


def test_cpu_run_is_correct_loads_no_jax_and_the_control_fails():
    """A tiny run of the cell in a process of its own holds no module of the
    JAX package and passes its limits; the fp8 control, in the program's
    place, fails them."""
    limits = harness.Cell(CELL).settings["limits"]
    out = _smoke(harness.REPO, CELL, TINY)
    assert out["forbidden"] == []
    assert all(out["numbers"][k] <= lim for k, lim in limits.items()), out["numbers"]
    control = _smoke(harness.REPO, CELL, dict(TINY, **{"settings.quantize": True}))
    assert any(control["numbers"][k] > lim for k, lim in limits.items()), control["numbers"]
