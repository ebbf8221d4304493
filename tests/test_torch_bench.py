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
PORTED_SERVE = {"serve": "mixed_res_dir_images_per_sec", "serve_http": "http_images_per_sec",
                "tiers": "fast_tier_images_per_sec"}
#: The streams/fleet/observability configs, with the JAX bench's contract
#: metric of each (JAX ``bench.py``'s metric table).
PORTED_STREAMS = {"serve_adaptive": "adaptive_p50_ms", "serve_chaos": "chaos_images_per_sec",
                  "serve_fleet": "fleet_images_per_sec", "stream": "video_stream_fps",
                  "stream_reuse": "stream_reuse_fps", "obs": "obs_overhead_pct",
                  "serve_multi": "mixed_res_dir_images_per_sec_multidev",
                  "train_chaos": "chaos_train_images_per_sec"}


@pytest.mark.parametrize("config", sorted({*bench.UNPORTED, *PORTED_SERVE, *PORTED_STREAMS}))
def test_unported_config_exits_2_naming_its_item(config, capsys, monkeypatch):
    if config in PORTED_STREAMS:
        # Ported: its line's metric is pinned without running it (all
        # but ``serve_fleet`` run below at a tiny size).
        import inspect

        assert config not in bench.UNPORTED
        assert f'"metric": "{PORTED_STREAMS[config]}"' in inspect.getsource(bench.SERVING_LINES[config])
        return
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


def test_unported_config_exit_status_from_the_cli():
    """No config is left unported: ``serve_multi`` (the last to exit 2)
    runs from the CLI at a smoke size, its two arms byte-equal, and on a
    one-device run its line says that it measured no scale-out."""
    assert bench.UNPORTED == {}
    proc = _bench("--config", "serve_multi", WATERNET_BENCH_HW="16", WATERNET_BENCH_SERVE_IMAGES="3",
                  WATERNET_BENCH_SERVE_BATCH="2", WATERNET_BENCH_SERVE_BUCKETS="1")
    assert proc.returncode == 0, proc.stderr
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["metric"] == "mixed_res_dir_images_per_sec_multidev" and line["value"] > 0
    assert line["replicas"] == 1 and line["replica_invariant"] is True and "no scale-out" in line["note"]


STREAM_SMOKE = {"WATERNET_BENCH_HW": "16", "WATERNET_BENCH_SERVE_IMAGES": "3", "WATERNET_BENCH_SERVE_BATCH": "2",
                "WATERNET_BENCH_SERVE_BUCKETS": "1", "WATERNET_BENCH_STREAMS": "2",
                "WATERNET_BENCH_STREAM_FRAMES": "3", "WATERNET_BENCH_OBS_ROUNDS": "1"}


def test_stream_config_ends_in_its_contract_line():
    """``--config stream`` at a tiny size (2 streams of 3 frames over 3
    images around 16²): the JAX line's fields, every frame accounted on
    both sides, nothing met cold."""
    proc = _bench("--config", "stream", **STREAM_SMOKE)
    assert proc.returncode == 0, proc.stderr
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["metric"] == "video_stream_fps" and line["unit"] == "fps/stream" and line["vs_baseline"] is None
    assert line["value"] > 0 and math.isfinite(line["value"]) and line["accounted"] is True
    assert {"calibrated_fps", "offered_fps_per_stream", "budget_ms", "p99_frame_ms", "p99_within_budget",
            "fps_per_stream_at_2x", "frames_delivered", "frames_dropped", "frames_out_of_budget",
            "stream_downgrades", "streams_refused", "fallback_native_shapes"} <= set(line)
    assert 0.0 <= line["drop_rate_at_2x"] <= 1.0 and 0.0 <= line["downgrade_rate_at_2x"] <= 1.0
    assert isinstance(line["p99_within_budget"], bool) and line["budget_ms"] > 0
    # Calibration (6 frames) and two phases of 2 x 3, every frame delivered.
    assert line["frames_delivered"] == 6 + 6 + 6 - line["frames_dropped"] - line["frames_out_of_budget"]
    assert (line["streams"], line["frames_per_stream"]) == (2, 3)
    assert line["cold_dispatches"] == 0 and line["compiles"] == 2 and line["device_kind"] == "cpu"


@pytest.mark.parametrize("config", ["obs", "stream_reuse"])
def test_obs_and_stream_reuse_lines_at_a_tiny_size(config, capsys, monkeypatch):
    for k, v in STREAM_SMOKE.items():
        monkeypatch.setenv(k, v)
    assert bench.main(["--config", config, "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == PORTED_STREAMS[config] and math.isfinite(line["value"])
    if config == "obs":
        assert line["byte_identical"] is True and line["spans_per_traced_run"] > 0 and line["spans_evicted"] == 0
    else:
        # 2 of 3 frames static at 75%: reuse answers them without compute.
        assert line["accounted"] is True and line["frames_reused"] > 0 and line["flicker_index_delta"] == 0.0


def test_serve_chaos_line_at_a_tiny_size():
    """``serve_chaos`` at the JAX contract test's size (6 images around
    24², 2 slots, 20 requests). The CPU gives one replica a tier, so the
    crashed replica itself must be quarantined, re-warmed and reintegrated
    while its batches wait, and every request reconciles with ``/stats``."""
    line = bench.bench_serving_chaos(torch.device("cpu"), n_images=6, max_batch=2, max_buckets=1, base_hw=24,
                                     concurrency=4, requests=20, watchdog_sec=2.0)
    assert line["metric"] == "chaos_images_per_sec" and line["unit"] == "images/sec" and line["value"] > 0
    assert line["replicas"] == 1 and line["note"].startswith("one replica a tier")
    assert line["quarantines"] >= 1 and line["reintegrations"] >= 1 and line["recovered"] is True
    assert line["recovery_sec"] > 0 and line["retried"] >= 1
    assert line["errors"] == 0 and line["conn_reset"] == 0 and line["accounted"] is True, line
    assert line["faults"] == "replica_crash@2,replica_hang@5"
    assert line["replica_health"] == {"quality": {0: "healthy"}, "fast": {0: "healthy"}}
    json.dumps(line)


def test_serve_adaptive_line_at_a_tiny_size(monkeypatch):
    """``serve_adaptive`` over 3 images around 16², 8 requests a phase:
    the low phase's answers byte-identical across the fixed and adaptive
    arms, and neither arm meets a shape mid-serve."""
    monkeypatch.setenv("WATERNET_BENCH_HW", "16")
    line = bench.bench_serve_adaptive(torch.device("cpu"), n_images=3, max_batch=2, max_buckets=1,
                                      requests_per_phase=8)
    assert line["metric"] == "adaptive_p50_ms" and line["unit"] == "ms"
    assert line["value"] > 0 and math.isfinite(line["value"]) and line["p50_unloaded_fixed_ms"] > 0
    assert line["byte_identical"] is True and line["cold_dispatches"] == 0
    assert line["compiles_mid_serve_fixed"] == 0 and line["compiles_mid_serve_adaptive"] == 0
    assert line["images_per_sec_fixed"] > 0 and line["images_per_sec_adaptive"] > 0
    assert (line["requests_per_phase"], line["n_images"], line["max_batch"]) == (8, 3, 2)
    json.dumps(line)


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
    """The int8 arm is ported now: ``WATERNET_QUANT=1`` prints the video
    line of the static int8 engine (at a 32 x 56 smoke size)."""
    for k, v in {"WATERNET_QUANT": "1", "WATERNET_BENCH_HW": "32", "WATERNET_BENCH_WARMUP": "1",
                 "WATERNET_BENCH_STEPS": "2"}.items():
        monkeypatch.setenv(k, v)
    assert bench.main(["--config", "video", "--device", "cpu", "--batch-size", "2"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tuple(line) == VIDEO and line["metric"] == "video_1080p_frames_per_sec_per_chip"
    assert line["quantized"] is True and line["precision"] == "int8"
    assert line["value"] > 0 and math.isfinite(line["value"]) and line["hw"] == [32, 56]


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
