"""The port's benchmark entry (``python -m waternet_tpu_torch.bench``), its
peak-FLOPs table (``obs/device.py``) and WaterNet's FLOP model, on the CPU.

The bench runs at a smoke size (2 x 32x32, 1 warm-up and 2 timed steps,
fp32, torch on two threads: the suite runs files side by side); its
numbers mean nothing here, only the lines' order and fields.
On the CPU the peak is unknown, so ``mfu`` and ``mfu_live`` are null.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from waternet_tpu.models.can import waternet_forward_flops as jax_waternet_forward_flops
from waternet_tpu_torch import bench
from waternet_tpu_torch.models import waternet_forward_flops
from waternet_tpu_torch.obs import device as obs_device

REPO = Path(__file__).resolve().parent.parent
SMOKE = {"WATERNET_BENCH_HW": "32", "WATERNET_BENCH_BATCH": "2", "WATERNET_BENCH_STEPS": "2",
         "WATERNET_BENCH_WARMUP": "1", "WATERNET_BENCH_PRECISION": "fp32", "OMP_NUM_THREADS": "2"}
CONTRACT = ("metric", "value", "unit", "vs_baseline", "step_ms", "preprocess_ms", "model_tflop_per_step",
            "mfu", "mfu_live", "hbm_peak_bytes", "peak_tflops_assumed", "device_kind", "batch", "hw",
            "precision", "device_cache", "precache_histeq", "precache_vgg_ref", "cache_build_sec",
            "cache_codec", "hbm_cache_bytes", "cache_compression_ratio")


@pytest.mark.parametrize(
    "name,precision,want",
    [
        ("NVIDIA H100 80GB HBM3", "bf16", 989.5),
        ("NVIDIA H100 80GB HBM3", "fp32", 67.0),
        ("NVIDIA H100 PCIe", "bf16", 756.5),
        ("NVIDIA H100 PCIe", "fp32", 51.0),
        ("NVIDIA A100-SXM4-80GB", "bf16", None),
    ],
)
def test_peak_tflops_by_card_name(monkeypatch, name, precision, want):
    monkeypatch.delenv(obs_device.PEAK_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: name)
    assert obs_device.peak_tflops(torch.device("cuda"), precision) == want


def test_peak_tflops_on_the_cpu_and_the_override(monkeypatch):
    monkeypatch.delenv(obs_device.PEAK_ENV, raising=False)
    assert obs_device.peak_tflops("cpu", "bf16") is None
    assert obs_device.hbm_peak_bytes("cpu") is None and obs_device.hbm_limit_bytes("cpu") is None
    monkeypatch.setenv(obs_device.PEAK_ENV, "123.5")
    assert obs_device.peak_tflops("cpu") == 123.5


@pytest.mark.parametrize("hw", [(112, 112), (256, 256), (37, 53)])
def test_waternet_forward_flops_matches_jax(hw):
    assert waternet_forward_flops(*hw) == jax_waternet_forward_flops(*hw)


def _bench(*args, **env):
    return subprocess.run(
        [sys.executable, "-m", "waternet_tpu_torch.bench", "--device", "cpu", *args],
        cwd=REPO, capture_output=True, text=True, timeout=600, env={**os.environ, **SMOKE, **env},
    )


@pytest.fixture(scope="module")
def train_lines():
    proc = _bench()
    assert proc.returncode == 0, proc.stderr
    return [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")], proc.stdout


def test_bench_prints_three_lines_contract_last(train_lines):
    lines, stdout = train_lines
    assert [ln["metric"] for ln in lines] == [
        "uieb_train_images_per_sec_per_chip_hostfed_sync",
        "uieb_train_images_per_sec_per_chip_hostfed",
        "uieb_train_images_per_sec_per_chip",
    ]
    assert json.loads(stdout.strip().splitlines()[-1]) == lines[-1]


def test_contract_line_fields(train_lines):
    line = train_lines[0][-1]
    assert tuple(line) == CONTRACT
    assert line["value"] > 0 and math.isfinite(line["value"])
    assert line["vs_baseline"] == pytest.approx(line["value"] / 12.0)
    assert line["device_cache"] and line["precache_histeq"] and not line["precache_vgg_ref"]
    assert line["cache_codec"] == "raw" and line["cache_compression_ratio"] == 1.0
    # Raw pairs plus WB, GC and the 8 CLAHE variants of 4 pairs at 32x32.
    assert line["hbm_cache_bytes"] == 4 * (2 + 2 + 8) * 32 * 32 * 3
    assert line["model_tflop_per_step"] > 0 and line["device_kind"] == "cpu"
    assert line["mfu"] is None and line["mfu_live"] is None and line["hbm_peak_bytes"] is None
    assert (line["batch"], line["hw"], line["precision"]) == (2, 32, "fp32")
    assert "compile_sec" not in line and "clahe_hist" not in line


def test_hostfed_lines_carry_the_pipeline_and_ab_fields(train_lines):
    sync, hostfed, _ = train_lines[0]
    assert sync["pipeline_workers"] == 0.0 and hostfed["pipeline_workers"] == 2.0
    u8 = 2 * 2 * 32 * 32 * 3
    assert sync["pipeline_transfer_bytes_per_batch"] == hostfed["pipeline_transfer_bytes_per_batch"] == u8
    assert hostfed["pipeline_epoch_images_per_sec"] > 0 and hostfed["hostpre_images_per_sec"] > 0
    assert hostfed["devpre_transfer_bytes_per_batch"] == u8
    assert hostfed["hostpre_transfer_bytes_per_batch"] == 5 * 4 * 2 * 32 * 32 * 3
    assert hostfed["h2d_bytes_reduction"] == 10.0
    assert "device_cache" not in hostfed


def test_train_fullres_ends_in_its_contract_line():
    """The raw arm refused by a capped headroom; dct8 trains."""
    proc = _bench("--config", "train_fullres", WATERNET_BENCH_FULLRES_HW="32", WATERNET_BENCH_FULLRES_BATCH="2",
                  WATERNET_BENCH_FULLRES_PERCEPTUAL="0", WATERNET_CACHE_HEADROOM_BYTES="30000")
    assert proc.returncode == 0, proc.stderr
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["metric"] == "train_fullres_devcache_images_per_sec" and line["value"] > 0
    assert line["codec"] == "dct8" and line["cache_compression_ratio"] == 4.0
    assert line["raw_fits"] is False and "30000 bytes headroom" in line["raw_refused"]
    assert line["raw_images_per_sec"] is None and math.isfinite(line["decoded_psnr_db"])


#: JAX bench configs that were unported and are now the port's own, with
#: the metric of the line each prints instead of exiting 2.
PORTED_SERVE = {"serve": "mixed_res_dir_images_per_sec", "serve_http": "http_images_per_sec"}


@pytest.mark.parametrize("config", sorted({*bench.UNPORTED, *PORTED_SERVE}))
def test_unported_config_exits_2_naming_its_item(config, capsys, monkeypatch):
    if config in PORTED_SERVE:
        # Ported: the config prints its line (at a smoke size) instead.
        for k, v in {"WATERNET_BENCH_HW": "16", "WATERNET_BENCH_SERVE_IMAGES": "3",
                     "WATERNET_BENCH_SERVE_BATCH": "2", "WATERNET_BENCH_SERVE_REQUESTS": "4"}.items():
            monkeypatch.setenv(k, v)
        assert config not in bench.UNPORTED
        assert bench.main(["--config", config, "--device", "cpu"]) == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["metric"] == PORTED_SERVE[config] and line["value"] > 0
        return
    assert bench.main(["--config", config, "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "ROADMAP Queue A item" in err and config in err
    if config == "tiers":
        assert "item 7" in err


def test_unported_config_exit_status_from_the_cli():
    proc = _bench("--config", "tiers")
    assert proc.returncode == 2 and "item 7" in proc.stderr and proc.stdout == ""


VIDEO = ("metric", "value", "unit", "vs_baseline", "batch", "frame_ms", "quantized", "mfu", "hbm_peak_bytes",
         "peak_tflops_assumed", "device_kind", "hw", "precision")


def test_video_config_ends_in_its_contract_line():
    """bf16 on the CPU: a 32 x 56 smoke size, 2 frames a batch."""
    proc = _bench("--config", "video", "--batch-size", "2")
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert tuple(line) == VIDEO
    assert line["metric"] == "video_1080p_frames_per_sec_per_chip" and line["unit"] == "frames/sec/chip"
    assert line["value"] > 0 and math.isfinite(line["value"]) and line["vs_baseline"] is None
    assert line["frame_ms"] == pytest.approx(1e3 / line["value"])
    assert (line["batch"], line["hw"], line["precision"]) == (2, [32, 56], "bf16")
    assert line["quantized"] is False
    assert line["mfu"] is None and line["hbm_peak_bytes"] is None and line["device_kind"] == "cpu"
    assert "compile_sec" not in line


def test_video_config_with_int8_exits_2_naming_item_7(capsys, monkeypatch):
    monkeypatch.setenv("WATERNET_QUANT", "1")
    assert bench.main(["--config", "video", "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "WATERNET_QUANT=1" in err and "ROADMAP Queue A item 7" in err


def test_bench_ab_alternates_sides_and_summarizes(monkeypatch, capsys):
    """``bench_ab`` runs the two checkouts in alternating order and
    reports each metric's median, quartiles and the pairs won."""
    from waternet_tpu_torch import bench_ab
    from waternet_tpu_torch.utils import device

    calls = []

    def fake(cwd, args):
        calls.append((cwd == bench_ab._HERE, tuple(args)))
        return {"m": 10.0 + len(calls) if cwd == bench_ab._HERE else 10.0}

    monkeypatch.setattr(bench_ab, "bench_values", fake)
    monkeypatch.setattr(device, "gpu_card_line", lambda: "card, 700.00 W")
    assert bench_ab.main(["--parent", "/elsewhere", "--pairs", "3", "--", "--config", "x"]) == 0
    assert [c[0] for c in calls] == [False, True, True, False, False, True]
    assert all(c[1] == ("--config", "x") for c in calls)
    out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()[1:]]
    assert [(d["pair"], d["side"]) for d in out[:6]] == [
        (1, "parent"), (1, "change"), (2, "change"), (2, "parent"), (3, "parent"), (3, "change")]
    summary = {d["side"]: d for d in out[6:]}
    assert summary["parent"]["median"] == 10.0 and summary["change"]["change_wins"] == 3
