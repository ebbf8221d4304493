"""Elastic multi-process training: a local gang supervisor.

The port of the JAX package's ``resilience/supervisor.py``: the same
state machine, backoff, drain, fault targeting, report and exit codes.
Workers are ``python -m waternet_tpu_torch.train`` processes.

Concurrency note (threadlint): this module is deliberately
single-threaded — isolation comes from *processes* (``subprocess.Popen``
+ heartbeat files), so there are no locks and nothing to declare
``guarded-by``. The supervisor loop owns all mutable state.

``python -m waternet_tpu_torch.resilience.supervisor`` spawns N training
worker processes and keeps the *job* alive across worker crash, hang, and
preemption:

1. **Gang launch.** Each generation gets a fresh coordinator port and a
   fresh heartbeat directory; workers receive the restart-context env
   contract (``WATERNET_COORDINATOR`` / ``_NUM_PROCESSES`` /
   ``_PROCESS_ID`` / ``_GENERATION`` / ``_HEARTBEAT_DIR``), which
   ``parallel.distributed.initialize`` and the train CLI consume — no
   worker-side flags needed. The workers join one ``torch.distributed``
   group and train data-parallel under ``DistributedDataParallel``.
2. **Health tracking.** Workers heartbeat at step boundaries
   (:mod:`waternet_tpu_torch.resilience.heartbeat`); the supervisor drives
   the per-worker ``starting -> running -> late -> presumed-hung`` machine
   off record freshness plus ``Popen.poll()``. A hang is detected by
   heartbeat timeout — never by waiting on a collective that will never
   complete.
3. **Coordinated restart.** On any worker failure, survivors are drained
   at a step boundary (SIGTERM -> checkpoint -> exit 0; a survivor stuck
   in a dead collective is SIGKILLed after ``drain_grace_sec``), the gang
   is torn down, and — after exponential backoff — a new generation
   relaunches with ``--resume auto``, resuming from the latest *complete,
   validated* checkpoint. The replay guarantee makes the finished job's
   metric CSVs and weights byte-identical to an uninterrupted run.
4. **Bounded budgets.** ``max_restarts`` caps restarts; when exhausted
   the supervisor prints a per-generation failure report and exits
   nonzero instead of hanging or retrying forever. The machine-readable
   report also lands at ``<heartbeat-dir>/supervisor-report.json``.

``--cpu-gloo`` sets ``WATERNET_CPU_GLOO=1`` in every worker: gloo
collectives whatever the device, so the gang can rehearse on the CPU or
with several ranks on one card (NCCL refuses two ranks on one GPU).

Deterministic fire drills: ``--worker-faults GEN:RANK:SPEC`` injects a
``WATERNET_FAULTS`` plan (e.g. ``proc_kill@3``) into exactly one worker
of exactly one generation, so recovery is a reproducible test, not a
chaos lottery (tests/test_torch_supervisor.py pins kill-mid-epoch
byte-exact).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

from waternet_tpu_torch.obs import trace
from waternet_tpu_torch.parallel import distributed as dist
from waternet_tpu_torch.resilience import heartbeat as hb

#: Exit code when the retry budget is exhausted (distinct from a worker's
#: own failure codes so wrappers can tell "job failed" from "launcher bug").
EXIT_BUDGET_EXHAUSTED = 3


def backoff_sec(base: float, cap: float, restart_index: int) -> float:
    """Exponential backoff before restart #``restart_index`` (1-based):
    base * 2**(i-1), capped. Pure, so the schedule is unit-testable."""
    return min(float(cap), float(base) * (2.0 ** (max(1, restart_index) - 1)))


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclasses.dataclass
class SupervisorConfig:
    num_workers: int = 1
    #: Restart budget: total generations allowed = max_restarts + 1.
    max_restarts: int = 3
    backoff_base_sec: float = 1.0
    backoff_cap_sec: float = 30.0
    #: Heartbeat freshness thresholds (see WorkerHealth).
    late_sec: float = 15.0
    hang_sec: float = 120.0
    startup_grace_sec: float = 600.0
    #: SIGTERM -> wait -> SIGKILL window for draining survivors.
    drain_grace_sec: float = 30.0
    poll_sec: float = 0.25
    #: Worker-side emission throttle (WATERNET_HEARTBEAT_SEC).
    heartbeat_sec: float = 1.0
    coordinator_host: str = "127.0.0.1"
    #: Rehearsal mode: workers get WATERNET_CPU_GLOO=1 (gloo collectives
    #: on the CPU or on shared cards).
    cpu_gloo: bool = False


class Supervisor:
    """Run one supervised job to completion (or budget exhaustion).

    ``worker_cmd`` is the base argv every worker runs (normally
    ``[sys.executable, "-m", "waternet_tpu_torch.train", ...train args]``); generation > 0 argv
    gains ``--resume auto`` unless the caller already passed ``--resume``.
    ``faults`` maps ``(generation, rank) -> WATERNET_FAULTS spec`` for
    deterministic fire drills; unlisted workers get the var *removed* so a
    drill never leaks into relaunched generations.
    """

    def __init__(
        self,
        worker_cmd,
        heartbeat_dir,
        config: Optional[SupervisorConfig] = None,
        env: Optional[dict] = None,
        faults: Optional[dict] = None,
    ):
        self.worker_cmd = [str(c) for c in worker_cmd]
        self.heartbeat_dir = Path(heartbeat_dir)
        self.config = config or SupervisorConfig()
        self.base_env = dict(os.environ if env is None else env)
        self.faults = dict(faults or {})
        self.generations: list = []  # per-generation report dicts
        self.restarts = 0
        self.recovery_secs: list = []  # failure-detect -> first new-gen beat

    # -- launch ---------------------------------------------------------

    def _worker_env(self, generation: int, rank: int, port: int, gen_dir: Path):
        env = dict(self.base_env)
        env[dist.ENV_COORDINATOR] = f"{self.config.coordinator_host}:{port}"
        env[dist.ENV_NUM_PROCESSES] = str(self.config.num_workers)
        env[dist.ENV_PROCESS_ID] = str(rank)
        env[dist.ENV_GENERATION] = str(generation)
        env[hb.ENV_HEARTBEAT_DIR] = str(gen_dir)
        env[hb.ENV_HEARTBEAT_SEC] = str(self.config.heartbeat_sec)
        spec = self.faults.get((generation, rank))
        if spec:
            env["WATERNET_FAULTS"] = spec
        else:  # a drill must never leak into other workers / generations
            env.pop("WATERNET_FAULTS", None)
        if self.config.cpu_gloo:
            env[dist.ENV_CPU_GLOO] = "1"
        return env

    def _worker_argv(self, generation: int):
        argv = list(self.worker_cmd)
        if generation > 0 and "--resume" not in argv:
            argv += ["--resume", "auto"]
        return argv

    def _spawn(self, generation: int, port: int, gen_dir: Path):
        argv = self._worker_argv(generation)
        procs = []
        for rank in range(self.config.num_workers):
            procs.append(
                subprocess.Popen(
                    argv, env=self._worker_env(generation, rank, port, gen_dir)
                )
            )
        return procs

    # -- monitor --------------------------------------------------------

    def _log(self, msg: str) -> None:
        print(f"[waternet-launch] {msg}", flush=True)

    def _sleep(self, sec: float) -> None:  # test seam (backoff assertions)
        time.sleep(sec)

    def _poll_health(self, procs, health, gen_dir: Path):
        """One monitor pass: fold fresh heartbeats, advance every state
        machine, log late workers, return the failure trigger (or None)."""
        now = time.time()
        trigger = None
        for rank, (p, w) in enumerate(zip(procs, health)):
            rec = hb.read_heartbeat(hb.heartbeat_path(gen_dir, rank))
            if rec is not None:
                w.note_beat(rec)
            prev = w.state
            state = w.observe(now, exit_code=p.poll())
            if state != prev and state == hb.LATE:
                self._log(
                    f"worker {rank} late: no heartbeat for "
                    f"{now - w.last_beat:.1f}s"
                )
            if trigger is None:
                if state == hb.DEAD:
                    trigger = (
                        f"worker {rank} exited rc={w.exit_code} "
                        f"(last step {w.last_step})"
                    )
                elif state == hb.HUNG:
                    since = (
                        f"{now - w.last_beat:.1f}s since last heartbeat"
                        if w.last_beat is not None
                        else "no heartbeat since launch"
                    )
                    trigger = f"worker {rank} presumed hung ({since})"
        return trigger

    def _drain(self, procs, health) -> None:
        """SIGTERM survivors (checkpoint at the next step boundary, exit
        0), give them ``drain_grace_sec``, SIGKILL stragglers — a
        worker wedged inside a dead collective never reaches a step
        boundary, so the grace is what bounds teardown."""
        for p in procs:
            if p.poll() is None:
                try:
                    p.send_signal(signal.SIGTERM)
                except OSError:
                    pass
        deadline = time.monotonic() + self.config.drain_grace_sec
        for p in procs:
            while p.poll() is None and time.monotonic() < deadline:
                self._sleep(min(self.config.poll_sec, 0.1))
            if p.poll() is None:
                self._log(f"worker pid {p.pid} did not drain; SIGKILL")
                p.kill()
            p.wait()

    # -- generation + job ------------------------------------------------

    def _run_generation(self, generation: int):
        """Launch + monitor one generation. Returns (ok, trigger)."""
        cfg = self.config
        port = _free_port()
        gen_dir = self.heartbeat_dir / f"gen-{generation:03d}"
        gen_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.time()
        t_gen0 = time.perf_counter()
        procs = self._spawn(generation, port, gen_dir)
        health = [
            hb.WorkerHealth(cfg.late_sec, cfg.hang_sec, cfg.startup_grace_sec, t0)
            for _ in procs
        ]
        self._log(
            f"generation {generation}: {cfg.num_workers} worker(s), "
            f"coordinator {cfg.coordinator_host}:{port}"
        )
        first_beat: Optional[float] = None
        trigger = None
        try:
            while True:
                trigger = self._poll_health(procs, health, gen_dir)
                if first_beat is None and any(
                    w.last_beat is not None for w in health
                ):
                    first_beat = time.time()
                    if self.recovery_secs and self.recovery_secs[-1] is None:
                        # close the recovery window the failure opened
                        self.recovery_secs[-1] = first_beat - self._failed_at
                if trigger is not None:
                    break
                if all(w.state == hb.DONE for w in health):
                    break
                self._sleep(cfg.poll_sec)
        finally:
            self._drain(procs, health)
            # a worker may have exited during/after drain: record it
            for p, w in zip(procs, health):
                if w.exit_code is None and p.poll() is not None:
                    w.exit_code = p.poll()
            self.generations.append(
                {
                    "generation": generation,
                    "trigger": trigger,
                    "duration_sec": time.time() - t0,
                    "workers": [w.summary() for w in health],
                }
            )
            # Fold the generation into the live trace timeline (in-proc
            # supervisors, e.g. tests/bench; waternet-trace --train-root
            # reconstructs the same view from artifacts after the fact).
            if trace.enabled():
                trace.record_span(
                    "generation", "supervisor", t_gen0,
                    time.perf_counter(),
                    args={"generation": generation, "trigger": trigger,
                          "workers": [w.state for w in health]},
                )
        return trigger is None, trigger

    def run(self) -> dict:
        """Supervise to completion; returns the job report (also written
        to ``<heartbeat-dir>/supervisor-report.json``)."""
        cfg = self.config
        self._failed_at = time.time()
        generation = 0
        while True:
            ok, trigger = self._run_generation(generation)
            if ok:
                return self._finish("completed")
            self._failed_at = time.time()
            self._log(f"generation {generation} failed: {trigger}")
            if self.restarts >= cfg.max_restarts:
                return self._finish("failed")
            self.restarts += 1
            self.recovery_secs.append(None)  # closed by the next first beat
            delay = backoff_sec(
                cfg.backoff_base_sec, cfg.backoff_cap_sec, self.restarts
            )
            self._log(
                f"restart {self.restarts}/{cfg.max_restarts} in {delay:.1f}s "
                "(resuming from the latest complete checkpoint)"
            )
            if trace.enabled():
                trace.record_instant(
                    "restart", "supervisor",
                    args={"generation": generation, "trigger": trigger,
                          "restart": self.restarts,
                          "backoff_sec": delay},
                )
            self._sleep(delay)
            generation += 1

    def _finish(self, result: str) -> dict:
        report = {
            "result": result,
            "restarts": self.restarts,
            "recovery_sec": [r for r in self.recovery_secs if r is not None],
            "generations": self.generations,
        }
        self.heartbeat_dir.mkdir(parents=True, exist_ok=True)
        (self.heartbeat_dir / "supervisor-report.json").write_text(
            json.dumps(report, indent=2)
        )
        if result != "completed":
            self._print_failure_report(report)
        else:
            self._log(
                f"job completed after {self.restarts} restart(s) "
                f"({len(self.generations)} generation(s))"
            )
        return report

    def _print_failure_report(self, report: dict) -> None:
        """The loud part of 'loud failure': a per-generation post-mortem on
        stderr, instead of a silent hang or an unbounded retry loop."""
        err = sys.stderr
        print("=" * 64, file=err)
        print(
            "[waternet-launch] RETRY BUDGET EXHAUSTED — "
            f"{report['restarts']} restart(s) used, job NOT complete",
            file=err,
        )
        for gen in report["generations"]:
            print(
                f"  generation {gen['generation']}: "
                f"{gen['trigger'] or 'completed'} "
                f"(ran {gen['duration_sec']:.1f}s)",
                file=err,
            )
            for rank, w in enumerate(gen["workers"]):
                print(
                    f"    worker {rank}: {w['state']} "
                    f"rc={w['exit_code']} last_step={w['last_step']}",
                    file=err,
                )
        print(
            f"  full report: {self.heartbeat_dir / 'supervisor-report.json'}",
            file=err,
        )
        print("=" * 64, file=err, flush=True)


def _parse_fault_arg(spec: str):
    """``"GEN:RANK:kind@K[,kind@K]"`` -> ((gen, rank), plan-spec)."""
    gen, _, rest = spec.partition(":")
    rank, _, plan = rest.partition(":")
    if not plan:
        raise ValueError(
            f"--worker-faults {spec!r}: expected GEN:RANK:SPEC "
            "(e.g. 0:1:proc_kill@3)"
        )
    return (int(gen), int(rank)), plan


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m waternet_tpu_torch.resilience.supervisor",
        description="Supervised elastic multi-process training. Everything "
        "after -- is passed to each 'python -m waternet_tpu_torch.train' "
        "worker verbatim.",
    )
    p.add_argument("--workers", type=int, default=1, metavar="N",
                   help="Worker processes to gang-launch (default 1)")
    p.add_argument("--max-restarts", type=int, default=3,
                   help="Restart budget; exhausted -> loud failure report + "
                   f"exit {EXIT_BUDGET_EXHAUSTED} (default 3)")
    p.add_argument("--backoff-sec", type=float, default=1.0,
                   help="Base of the exponential restart backoff (default 1)")
    p.add_argument("--backoff-cap-sec", type=float, default=30.0,
                   help="Backoff ceiling in seconds (default 30)")
    p.add_argument("--late-sec", type=float, default=15.0,
                   help="Heartbeat age after which a worker is logged late")
    p.add_argument("--hang-sec", type=float, default=120.0,
                   help="Heartbeat age after which a worker is presumed hung "
                   "and the gang restarts (cover your longest val epoch)")
    p.add_argument("--startup-grace-sec", type=float, default=600.0,
                   help="Time allowed before the FIRST heartbeat "
                   "(compilation + data warmup)")
    p.add_argument("--drain-grace-sec", type=float, default=30.0,
                   help="SIGTERM->SIGKILL window when tearing a gang down")
    p.add_argument("--heartbeat-sec", type=float, default=1.0,
                   help="Worker heartbeat emission throttle (default 1)")
    p.add_argument("--heartbeat-dir", type=str, default=None,
                   help="Supervision state root (heartbeats + report); "
                   "default: supervise/<pid> under the repo")
    p.add_argument("--cpu-gloo", action="store_true",
                   help="Rehearsal: workers run gloo collectives whatever "
                   "their device (the CPU, or several ranks sharing a card, "
                   "which NCCL refuses)")
    p.add_argument("--worker-faults", action="append", default=[],
                   metavar="GEN:RANK:SPEC",
                   help="Deterministic fire drill: inject WATERNET_FAULTS "
                   "SPEC (e.g. proc_kill@3) into worker RANK of generation "
                   "GEN only. Repeatable")
    p.add_argument("--worker-cmd", type=str, default=None,
                   help="Override the worker executable (default: "
                   "'<python> -m waternet_tpu_torch.train'); the -- args "
                   "still apply")
    p.add_argument("train_args", nargs=argparse.REMAINDER,
                   help="Arguments after -- go to every worker")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    train_args = list(args.train_args)
    if train_args and train_args[0] == "--":
        train_args = train_args[1:]
    repo = Path(__file__).resolve().parents[2]
    if args.worker_cmd:
        worker_cmd = args.worker_cmd.split() + train_args
    else:
        worker_cmd = [sys.executable, "-m", "waternet_tpu_torch.train"] + train_args
    heartbeat_dir = Path(args.heartbeat_dir or repo / "supervise" / str(os.getpid()))
    # The workers import the package from this checkout, whatever their cwd.
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(repo), env.get("PYTHONPATH")) if p)
    cfg = SupervisorConfig(
        num_workers=args.workers,
        max_restarts=args.max_restarts,
        backoff_base_sec=args.backoff_sec,
        backoff_cap_sec=args.backoff_cap_sec,
        late_sec=args.late_sec,
        hang_sec=args.hang_sec,
        startup_grace_sec=args.startup_grace_sec,
        drain_grace_sec=args.drain_grace_sec,
        heartbeat_sec=args.heartbeat_sec,
        cpu_gloo=args.cpu_gloo,
    )
    faults = dict(_parse_fault_arg(s) for s in args.worker_faults)
    sup = Supervisor(worker_cmd, heartbeat_dir, cfg, env=env, faults=faults)
    report = sup.run()
    return 0 if report["result"] == "completed" else EXIT_BUDGET_EXHAUSTED


if __name__ == "__main__":
    raise SystemExit(main())
