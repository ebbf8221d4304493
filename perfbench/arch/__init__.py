"""One module per architecture: the weights made from the seed, the
program's engines built on them, and the plain reference's output on the
same inputs. A configuration file names its architecture under ``arch``,
so a new configuration of a known architecture is a data file alone."""

from __future__ import annotations

import importlib


def load(cfg: dict):
    return importlib.import_module(f"perfbench.arch.{cfg['arch']}")
