"""Multi-process initialization and batch distribution on ``torch.distributed``.

The port of the JAX package's ``parallel/distributed.py``, with its env
contract (the ``WATERNET_*`` names, :class:`RestartContext`,
:func:`restart_context`, :func:`generation`) lifted verbatim. What
``jax.distributed.initialize`` did becomes ``torch.distributed.
init_process_group`` on a TCP store at the coordinator's address:

1. every process calls :func:`initialize`; under the supervisor
   (``resilience/supervisor.py``) it reads the restart context from the
   environment, a fresh coordinator port and generation per relaunch;
2. the backend is ``nccl`` for CUDA, or ``gloo`` when
   ``WATERNET_CPU_GLOO`` is set or the device is the CPU (gloo also moves
   CUDA tensors, staging them through the host: the rehearsal of several
   ranks on one card, which NCCL refuses);
3. each process trains one data shard under ``DistributedDataParallel``;
   every rank builds the same global batch from the seed, and
   :func:`local_batch_slice` says which rows are its own.

Without the contract nothing is initialized and the process runs alone.
The port reads no second contract: torchrun's ``RANK``/``MASTER_ADDR``
are not consulted.
"""

from __future__ import annotations

import datetime
import os
import sys
from typing import NamedTuple, Optional

import torch

# ---------------------------------------------------------------------------
# Restart-context env contract: the supervisor stamps these into each
# worker's environment, a fresh coordinator port and generation per
# relaunch; :func:`initialize` with no explicit arguments consumes them.
# Absent all of them, the process runs alone.
# ---------------------------------------------------------------------------
ENV_COORDINATOR = "WATERNET_COORDINATOR"
ENV_NUM_PROCESSES = "WATERNET_NUM_PROCESSES"
ENV_PROCESS_ID = "WATERNET_PROCESS_ID"
ENV_GENERATION = "WATERNET_GENERATION"
#: Rehearsal flag: gloo collectives whatever the device (several ranks on
#: one card, or on the CPU).
ENV_CPU_GLOO = "WATERNET_CPU_GLOO"
#: Bounded coordinator-connect timeout (seconds) for explicit mode.
ENV_CONNECT_TIMEOUT = "WATERNET_CONNECT_TIMEOUT_SEC"

_CONTEXT_VARS = (ENV_COORDINATOR, ENV_NUM_PROCESSES, ENV_PROCESS_ID)


class RestartContext(NamedTuple):
    """One worker's identity within a supervised (possibly relaunched) job."""

    coordinator_address: str
    num_processes: int
    process_id: int
    generation: int


def restart_context(env=None) -> Optional[RestartContext]:
    """Parse the supervisor's env contract; None when absent.

    A *partial* contract (some of the three identity vars set, others not)
    is a wiring bug that would silently train N duplicate single-process
    runs — it raises, naming exactly what is set and what is missing.
    """
    env = os.environ if env is None else env
    present = {v: env.get(v) for v in _CONTEXT_VARS if env.get(v) is not None}
    if not present:
        return None
    if len(present) != len(_CONTEXT_VARS):
        missing = [v for v in _CONTEXT_VARS if v not in present]
        raise ValueError(
            f"partial multi-process restart context: {present} set but "
            f"{missing} missing — the supervisor must provide all of "
            f"{_CONTEXT_VARS}"
        )
    return RestartContext(
        coordinator_address=env[ENV_COORDINATOR],
        num_processes=int(env[ENV_NUM_PROCESSES]),
        process_id=int(env[ENV_PROCESS_ID]),
        generation=int(env.get(ENV_GENERATION, "0")),
    )


def generation(env=None) -> int:
    """The restart generation this process belongs to (0 unsupervised)."""
    env = os.environ if env is None else env
    return int(env.get(ENV_GENERATION, "0"))


def gloo_requested(env=None) -> bool:
    env = os.environ if env is None else env
    return env.get(ENV_CPU_GLOO, "") in ("1", "true")


def backend_for(device) -> str:
    """``gloo`` on the CPU or under ``WATERNET_CPU_GLOO``, else ``nccl``."""
    if gloo_requested() or torch.device(device).type == "cpu":
        return "gloo"
    return "nccl"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    connect_timeout_sec: Optional[float] = None,
    device="cuda",
) -> bool:
    """Join the process group (idempotent); True when this process is one
    of several.

    Without arguments the supervisor's env contract (:func:`restart_context`)
    supplies the coordinator (``host:port``), the world size and the rank;
    without the contract this is a no-op and the process runs alone.
    ``device`` picks the backend (:func:`backend_for`). The join waits at
    most ``connect_timeout_sec`` (default ``WATERNET_CONNECT_TIMEOUT_SEC``,
    else 300 s); a failure raises ``RuntimeError`` naming the coordinator,
    the rank and world size, the generation and every env var consulted,
    instead of letting each process train an independent duplicate run.
    """
    dist = torch.distributed
    if dist.is_initialized():
        return dist.get_world_size() > 1
    ctx = None
    if coordinator_address is None and num_processes is None:
        ctx = restart_context()  # a partial contract raises here, loudly
        if ctx is None:
            return False
        coordinator_address, num_processes, process_id = (
            ctx.coordinator_address, ctx.num_processes, ctx.process_id)
    if connect_timeout_sec is None:
        timeout = float(os.environ.get(ENV_CONNECT_TIMEOUT, "300"))
    else:
        timeout = float(connect_timeout_sec)
    backend = backend_for(device)
    try:
        dist.init_process_group(
            backend=backend,
            init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes),
            rank=int(process_id or 0),
            timeout=datetime.timedelta(seconds=max(1.0, timeout)),
        )
    except (RuntimeError, ValueError, OSError) as e:  # torch's DistError is a RuntimeError
        gen = ctx.generation if ctx is not None else generation()
        consulted = ", ".join(
            f"{v}={os.environ.get(v)!r}"
            for v in (*_CONTEXT_VARS, ENV_GENERATION, ENV_CPU_GLOO, ENV_CONNECT_TIMEOUT)
        )
        raise RuntimeError(
            f"multi-process init failed: process {process_id}/{num_processes} "
            f"could not join coordinator {coordinator_address} within "
            f"{timeout:.0f}s over {backend} (restart generation {gen}; "
            f"{type(e).__name__}: {e}). Env consulted: {consulted}"
        ) from e
    if dist.get_world_size() > 1:
        print(f"[waternet_tpu_torch] process {dist.get_rank()}/{dist.get_world_size()} "
              f"joined {coordinator_address} over {backend}", file=sys.stderr, flush=True)
    return dist.get_world_size() > 1


def process_index() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def local_batch_slice(global_batch: int, rank: Optional[int] = None,
                      world: Optional[int] = None) -> slice:
    """The half-open index range of the global batch process ``rank`` (of
    ``world``) owns; by default this process's. The JAX package's
    formula: the remainder goes one row each to the first ranks.

    Dataset indices are shuffled with the same seed on every rank, so
    slicing the order per rank partitions the epoch without communication.
    """
    n = process_count() if world is None else int(world)
    i = process_index() if rank is None else int(rank)
    per = global_batch // n
    rem = global_batch % n
    start = i * per + min(i, rem)
    return slice(start, start + per + (1 if i < rem else 0))


def process_devices(device, n_spatial: int = 1, rank: Optional[int] = None,
                    rehearse: Optional[bool] = None) -> list:
    """The ``n_spatial`` devices process ``rank`` owns: ``[rank * S,
    (rank + 1) * S)`` of the visible CUDA devices, or ``["cpu"] * S``.

    On CUDA, fewer cards than that raises, unless ``rehearse`` (default:
    ``WATERNET_CPU_GLOO`` is set) lets the indices wrap around the cards
    there are, so that several ranks or shards share a card: the layout
    that rehearses a multi-GPU job on one."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [dev] * n_spatial
    rank = process_index() if rank is None else rank
    rehearse = gloo_requested() if rehearse is None else rehearse
    count = torch.cuda.device_count()
    first = dev.index or 0
    want = [first + rank * n_spatial + j for j in range(n_spatial)]
    if max(want) >= count:
        if not rehearse or count == 0:
            raise ValueError(
                f"process {rank} with {n_spatial} spatial shard(s) needs CUDA devices "
                f"{want}, but only {count} are visible (set {ENV_CPU_GLOO}=1 to "
                "rehearse on the cards there are)"
            )
        want = [i % count for i in want]
    return [torch.device("cuda", i) for i in want]
