"""Auto-numbered run directories (the reference's savedir convention):
numeric subdirs under a base output dir, the next run gets ``max + 1``;
creation is deferred so early failures leave no empty dirs."""

from __future__ import annotations

from pathlib import Path


def next_run_dir(base: Path, name: str | None = None) -> Path:
    """Pick (but do not create) the run directory under ``base``."""
    base = Path(base)
    if name is not None:
        return base / name
    if not base.exists():
        return base / "0"
    nums = [
        int(p.stem) for p in base.glob("*") if p.is_dir() and p.stem.isdecimal()
    ]
    return base / (str(max(nums) + 1) if nums else "0")


def run_dirs_desc(base: Path) -> list[Path]:
    """All numbered run dirs under ``base``, newest (highest) first:
    ``--resume auto`` walks them, so a latest run that holds nothing
    restorable falls back to earlier runs."""
    base = Path(base)
    if not base.exists():
        return []
    nums = sorted((int(p.stem) for p in base.glob("*") if p.is_dir() and p.stem.isdecimal()), reverse=True)
    return [base / str(n) for n in nums]
