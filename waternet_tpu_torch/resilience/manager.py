"""Checkpoint manager: atomic finalize, retention, validated auto-resume.

The JAX package's ``resilience/manager.py`` over the port's state format
(:func:`waternet_tpu_torch.utils.checkpoint.save_state_atomic`: one
``state.pt`` in place of an Orbax tree). Layout under a run dir
(``training/<n>/checkpoints/``)::

    step-0000000042/
        state/            state.pt (params + Adam moments + schedule + step)
        _COMPLETE.json    marker, written LAST; holds the resume metadata

The marker is the finalize: a checkpoint without it is, by construction,
half-written (the directory itself appears atomically via tmp +
``os.replace`` in :func:`waternet_tpu_torch.utils.checkpoint.save_state_atomic`,
and the marker lands only after that rename). Readers therefore never need
to guess — :meth:`CheckpointManager.restore_latest_good` walks checkpoints
newest-first, skips unmarked ones, *test-restores* marked ones, and falls
back to the previous checkpoint when restore fails (truncated payloads,
torn volumes — the cases a marker alone can't catch).

Resume metadata records the exact dataloader position ``(epoch,
batch_index)`` plus the per-step metrics of the partial epoch and the
completed-epoch history, so a resumed run reproduces the uninterrupted
run's CSV artifacts bit-for-bit (batch composition is a pure function of
``(seed, epoch)`` via the shared Philox stream).

Retention keeps the last ``keep`` checkpoints by step plus the single best
by validation PSNR — the one you'd actually ship if the run dies for good.

The port runs one process (multi-GPU is ROADMAP Queue A item 8), so this
process writes the state, the marker, and runs pruning and the fault hook.
"""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path
from typing import NamedTuple, Optional

MARKER = "_COMPLETE.json"

#: A *finalized* step dir is exactly ``step-<digits>``. Anything else the
#: glob can catch — ``step-42.tmp`` / ``step-42.orbax-checkpoint-tmp-...`` (the JAX package's)
#: staging conventions of a concurrently-finalizing peer generation — is
#: in-progress by construction and must never be scanned as a checkpoint.
_STEP_DIR = re.compile(r"step-\d+")


class Checkpoint(NamedTuple):
    path: Path  # the step-* directory
    step: int
    meta: dict

    @property
    def state_dir(self) -> Path:
        return self.path / "state"


class CheckpointManager:
    def __init__(self, root, keep: int = 3):
        self.root = Path(root)
        self.keep = max(1, int(keep))
        self._saves = 0  # ordinal for the fault-injection hook

    # ------------------------------------------------------------------
    # Write path
    # ------------------------------------------------------------------

    def save(self, engine, meta: Optional[dict] = None) -> Path:
        """Atomic checkpoint of ``engine``'s full train state + metadata."""
        import os

        from waternet_tpu_torch.resilience import faults

        meta = dict(meta or {})
        step = int(meta.get("step", getattr(engine, "_host_step", 0)))
        meta["step"] = step
        final = self.root / f"step-{step:010d}"
        # The state is saved into a tmp sibling; the whole step dir then
        # appears atomically, and the marker is written strictly after.
        tmp = self.root / f".tmp-step-{step:010d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        if final.exists():  # re-save of the same step (epoch end after
            shutil.rmtree(final)  # an interval save): replace it
        engine.checkpoint(tmp / "state")
        self._saves += 1
        os.replace(tmp, final)
        (final / MARKER).write_text(json.dumps(meta, indent=2))
        faults.after_checkpoint_save(final, self._saves)
        self.prune()
        return final

    def prune(self) -> None:
        """Keep the newest ``keep`` checkpoints + the best-val-PSNR one."""
        cks = self.checkpoints()
        if len(cks) <= self.keep:
            return
        keep = set(ck.path for ck in cks[-self.keep :])
        scored = [ck for ck in cks if ck.meta.get("val_psnr") is not None]
        if scored:
            best = max(scored, key=lambda ck: ck.meta["val_psnr"])
            keep.add(best.path)
        for ck in cks:
            if ck.path not in keep:
                shutil.rmtree(ck.path, ignore_errors=True)

    # ------------------------------------------------------------------
    # Read path
    # ------------------------------------------------------------------

    def checkpoints(self) -> list:
        """Complete (marker-finalized) checkpoints, ascending by step.

        Concurrency-tolerant by construction: a restarting peer generation
        may be finalizing (``*.tmp`` staging) or pruning (entries vanish
        between the glob and the marker read) this very directory. Staging
        names are rejected by pattern; a vanished/torn marker read raises
        ``OSError``/``JSONDecodeError`` and the entry is simply skipped —
        the marker protocol guarantees anything skipped was not (or no
        longer is) a complete checkpoint.
        """
        out = []
        try:
            entries = sorted(self.root.glob("step-*"))
        except OSError:  # root itself vanished mid-scan
            return out
        for p in entries:
            if not _STEP_DIR.fullmatch(p.name):
                continue  # in-progress staging dir, never a checkpoint
            # No is_dir/is_file pre-checks: they would only widen the
            # check-to-read race. The read itself is the check.
            try:
                meta = json.loads((p / MARKER).read_text())
            except (OSError, json.JSONDecodeError):
                continue  # unfinalized, torn, or vanished mid-scan
            out.append(Checkpoint(p, int(meta.get("step", -1)), meta))
        out.sort(key=lambda ck: ck.step)
        return out

    def restore_latest_good(self, engine) -> Optional[Checkpoint]:
        """Restore the newest checkpoint that actually loads.

        Integrity validation IS a restore attempt: a truncated or corrupt
        checkpoint raises inside ``engine.restore`` and we fall back to the
        previous one instead of crashing, warning loudly about each reject.
        A model-config MISMATCH is not corruption: every checkpoint of the
        run would fail identically and the fallback would silently retrain
        from scratch, so it propagates (with the shape report) instead.
        """
        import warnings

        from waternet_tpu_torch.training.trainer import CheckpointMismatchError

        for ck in reversed(self.checkpoints()):
            if not ck.state_dir.is_dir():
                continue  # pruned by a peer between the scan and this
                # restore attempt: not corruption, just gone — skip quietly
            try:
                engine.restore(ck.state_dir)
                return ck
            except CheckpointMismatchError:
                raise
            except Exception as e:  # corrupt/truncated: fall back
                warnings.warn(
                    f"checkpoint {ck.path.name} failed to restore "
                    f"({type(e).__name__}: {e}); falling back to the "
                    "previous checkpoint",
                    RuntimeWarning,
                    stacklevel=2,
                )
        return None


def auto_resume(engine, training_base) -> Optional[dict]:
    """``--resume auto``: restore the newest good state across run dirs.

    Walks run dirs newest-first. Per run: managed checkpoints first (with
    corrupt-checkpoint fallback), then the legacy per-epoch ``state/`` dir.
    Returns the resume metadata dict (``{}`` for legacy states, which carry
    no position — training restarts its epoch loop with restored params,
    moments, and schedule), or ``None`` for a fresh start.
    """
    import warnings

    from waternet_tpu_torch.training.trainer import CheckpointMismatchError
    from waternet_tpu_torch.utils.rundir import run_dirs_desc

    for run in run_dirs_desc(training_base):
        mgr = CheckpointManager(run / "checkpoints")
        ck = mgr.restore_latest_good(engine)
        if ck is not None:
            print(f"Auto-resuming from {ck.path}")
            return ck.meta
        legacy = run / "state"
        if legacy.is_dir():
            try:
                engine.restore(legacy)
                print(f"Auto-resuming from legacy checkpoint {legacy}")
                return {}
            except CheckpointMismatchError:
                raise
            except Exception as e:
                warnings.warn(
                    f"legacy checkpoint {legacy} failed to restore "
                    f"({type(e).__name__}: {e}); trying earlier runs",
                    RuntimeWarning,
                    stacklevel=2,
                )
    return None
