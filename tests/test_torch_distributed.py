"""The port's multi-process layer against the JAX package's, on the CPU.

* the ``WATERNET_*`` restart-context contract, parsed by both packages from
  the same env dicts: the same contexts, the same loud errors;
* ``initialize``: a no-op without the contract, a loud ``RuntimeError``
  naming everything consulted when the coordinator is dead (1 s timeout);
* ``local_batch_slice`` against the JAX formula over a grid of batch and
  world sizes;
* a 2-process gloo ``DistributedDataParallel`` run (one intra-op thread a
  process, so both round alike) through the dct8 device cache, the raw
  cache with its precache tables, host-fed with a global batch of 3 (one
  padded, masked row), host preprocessing, distillation (the student
  trained, the teacher frozen on each rank) and 2 spatial shards a
  process: both ranks end with
  bit-identical parameters and log identical metrics, and the run's
  metrics lie within rel 1e-4 of the 1-process run at the same global
  batch (the ranks' loss scale and the all-reduced metric sums reproduce
  the global mean up to float reassociation). Its parameters lie within 2
  x lr a step of the 1-process run's: Adam normalizes each update to about
  lr, so a gradient near 0 whose sign the reassociation flips moves its
  parameter by up to 2 x lr (ROADMAP Queue C's first-step sign
  sensitivity); the metrics are what the bound is about.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from waternet_tpu.parallel import distributed as jax_dist
from waternet_tpu_torch.parallel import distributed as dist

REPO = Path(__file__).resolve().parent.parent
TEACHER = str(REPO / "tests" / "fixtures" / "distill" / "teacher.npz")
VARIANTS = ["dct8_cached", "raw_precached", "hostfed_batch3", "host_preprocess", "distill", "spatial2"]

ENVS = {
    "absent": {},
    "full": {dist.ENV_COORDINATOR: "10.0.0.1:1234", dist.ENV_NUM_PROCESSES: "4",
             dist.ENV_PROCESS_ID: "2", dist.ENV_GENERATION: "3"},
    "no_generation": {dist.ENV_COORDINATOR: "h:1", dist.ENV_NUM_PROCESSES: "2", dist.ENV_PROCESS_ID: "0"},
    "coordinator_only": {dist.ENV_COORDINATOR: "h:1"},
    "no_rank": {dist.ENV_COORDINATOR: "h:1", dist.ENV_NUM_PROCESSES: "2", dist.ENV_GENERATION: "1"},
    "rank_only": {dist.ENV_PROCESS_ID: "1"},
}


def test_env_names_are_the_jax_packages():
    for name in ("ENV_COORDINATOR", "ENV_NUM_PROCESSES", "ENV_PROCESS_ID", "ENV_GENERATION",
                 "ENV_CPU_GLOO", "ENV_CONNECT_TIMEOUT"):
        assert getattr(dist, name) == getattr(jax_dist, name)
    assert dist.RestartContext._fields == jax_dist.RestartContext._fields


@pytest.mark.parametrize("case", sorted(ENVS))
def test_restart_context_equals_jax(case):
    env = ENVS[case]
    try:
        want = jax_dist.restart_context(env=env)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            dist.restart_context(env=env)
        assert str(got.value) == str(e)
        assert "missing" in str(e)
        return
    got = dist.restart_context(env=env)
    assert got == want and (got is None) == (case == "absent")
    assert dist.generation(env=env) == jax_dist.generation(env=env)


def test_initialize_without_the_contract_is_a_noop(monkeypatch):
    for v in (dist.ENV_COORDINATOR, dist.ENV_NUM_PROCESSES, dist.ENV_PROCESS_ID):
        monkeypatch.delenv(v, raising=False)
    assert dist.initialize(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert (dist.process_index(), dist.process_count()) == (0, 1)
    assert dist.local_batch_slice(16) == slice(0, 16)


def _dead_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_initialize_failure_names_coordinator_and_env(monkeypatch):
    monkeypatch.setenv(dist.ENV_GENERATION, "4")
    addr = f"127.0.0.1:{_dead_port()}"
    with pytest.raises(RuntimeError) as ei:
        dist.initialize(addr, num_processes=2, process_id=1, connect_timeout_sec=1, device="cpu")
    msg = str(ei.value)
    assert addr in msg and "process 1/2" in msg and "within 1s" in msg
    assert "restart generation 4" in msg and "gloo" in msg
    for v in (dist.ENV_COORDINATOR, dist.ENV_NUM_PROCESSES, dist.ENV_PROCESS_ID, dist.ENV_GENERATION,
              dist.ENV_CPU_GLOO, dist.ENV_CONNECT_TIMEOUT):
        assert v in msg
    assert not torch.distributed.is_initialized()


def test_local_batch_slice_equals_jax_over_a_grid(monkeypatch):
    for world in range(1, 9):
        for batch in range(0, 21):
            slices = [dist.local_batch_slice(batch, r, world) for r in range(world)]
            for r, sl in enumerate(slices):
                monkeypatch.setattr(jax_dist.jax, "process_count", lambda w=world: w)
                monkeypatch.setattr(jax_dist.jax, "process_index", lambda r=r: r)
                assert sl == jax_dist.local_batch_slice(batch)
            assert [i for sl in slices for i in range(sl.start, sl.stop)] == list(range(batch))


def test_backend_and_process_devices(monkeypatch):
    monkeypatch.delenv(dist.ENV_CPU_GLOO, raising=False)
    assert dist.backend_for("cpu") == "gloo" and dist.backend_for("cuda") == "nccl"
    monkeypatch.setenv(dist.ENV_CPU_GLOO, "1")
    assert dist.backend_for("cuda") == "gloo"
    assert dist.process_devices("cpu", 3, rank=1) == [torch.device("cpu")] * 3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="only 2 are visible"):
        dist.process_devices("cuda", 2, rank=1, rehearse=False)
    assert dist.process_devices("cuda", 1, rank=1, rehearse=False) == [torch.device("cuda", 1)]
    assert dist.process_devices("cuda", 2, rank=1, rehearse=True) == [torch.device("cuda", 0), torch.device("cuda", 1)]


# ----------------------------------------------------------------------
# 2-process DDP on gloo
# ----------------------------------------------------------------------

_WORKER = r"""
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
out, world, rank, port = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
from waternet_tpu_torch.parallel import distributed as pdist
if world > 1:
    assert pdist.initialize(f"127.0.0.1:{port}", world, rank, connect_timeout_sec=120, device="cpu")
from waternet_tpu_torch.data.synthetic import SyntheticPairs
from waternet_tpu_torch.training.trainer import TrainConfig, TrainingEngine

from waternet_tpu_torch.hub import resolve_weights

idx = np.arange(12)
result = {}
for name, batch, hw, extra in (
        ("dct8_cached", 4, (24, 24), dict(cache_codec="dct8")),
        ("raw_precached", 4, (24, 24), dict(cache_codec="raw")),
        ("hostfed_batch3", 3, (24, 24), dict(perceptual_weight=0.05)),
        ("host_preprocess", 4, (24, 24), dict(host_preprocess=True)),
        ("distill", 4, (24, 24), dict(distill=True, student_width=8, student_depth=3)),
        ("spatial2", 4, (56, 24), dict(spatial_shards=2))):
    data = SyntheticPairs(12, *hw, seed=0)
    cfg = TrainConfig(batch_size=batch, im_height=hw[0], im_width=hw[1], precision="fp32", seed=0,
                      **{"perceptual_weight": 0.0, **extra})
    teacher = resolve_weights(sys.argv[5]) if cfg.distill else None
    engine = TrainingEngine(cfg, device="cpu", teacher_params=teacher)
    assert engine._world == world
    torch.save(engine.model.state_dict(), f"{out}/{name}-init-rank{rank}.pt")
    if name.endswith("cached"):
        engine.cache_dataset(data, idx)
        metrics = engine.train_epoch_cached(0)
        val = engine.eval_epoch_cached()
    else:
        metrics = engine.train_epoch(data.batches(idx, batch, shuffle=True, seed=0, epoch=0), 0)
        val = engine.eval_epoch(data.batches(idx[:4], batch, shuffle=False))
    torch.save(engine.model.state_dict(), f"{out}/{name}-rank{rank}.pt")
    result[name] = {"train": metrics, "val": val}
with open(f"{out}/metrics-rank{rank}.json", "w") as f:
    json.dump(result, f)
pdist.shutdown()
"""


def _run_workers(out: Path, world: int) -> None:
    port = _dead_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(out), str(world), str(r), str(port), TEACHER],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)


@pytest.fixture(scope="module")
def ddp_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddp")
    for world in (1, 2):
        (root / str(world)).mkdir()
        _run_workers(root / str(world), world)
    return root


@pytest.mark.parametrize("name", VARIANTS)
def test_ddp_ranks_end_bit_identical(ddp_runs, name):
    a = torch.load(ddp_runs / "2" / f"{name}-rank0.pt")
    b = torch.load(ddp_runs / "2" / f"{name}-rank1.pt")
    assert all(torch.equal(a[k], b[k]) for k in a)
    m0, m1 = (json.loads((ddp_runs / "2" / f"metrics-rank{r}.json").read_text())[name] for r in (0, 1))
    assert m0 == m1


@pytest.mark.parametrize("name", VARIANTS)
def test_ddp_matches_the_one_process_run(ddp_runs, name):
    """The 2-rank run's parameter update (final minus initial, over every
    parameter) lies within 1e-2 of the 1-process update in relative norm.
    Gradients that differed would put it near 1: Adam moves each
    parameter by about lr whatever the gradient's size. The largest
    measured on the CPU is 6.85e-4 (``raw_precached``; a near-zero gradient
    whose rounding flips its sign moves one weight by up to 2 lr), the
    others at most 3.9e-5, so the bound has 14x headroom. The step's
    metrics hold the run at rel 1e-4."""
    init = torch.load(ddp_runs / "1" / f"{name}-init-rank0.pt")
    one = torch.load(ddp_runs / "1" / f"{name}-rank0.pt")
    two = torch.load(ddp_runs / "2" / f"{name}-rank0.pt")
    assert all(torch.equal(init[k], torch.load(ddp_runs / "2" / f"{name}-init-rank0.pt")[k]) for k in init)
    upd1 = torch.cat([(one[k] - init[k]).ravel().double() for k in init])
    upd2 = torch.cat([(two[k] - init[k]).ravel().double() for k in init])
    assert upd1.norm() > 0
    assert ((upd1 - upd2).norm() / upd1.norm()).item() <= 1e-2
    m1 = json.loads((ddp_runs / "1" / "metrics-rank0.json").read_text())[name]
    m2 = json.loads((ddp_runs / "2" / "metrics-rank0.json").read_text())[name]
    for part in ("train", "val"):
        for k, v in m1[part].items():
            assert m2[part][k] == pytest.approx(v, rel=1e-4, abs=1e-9), (part, k)
