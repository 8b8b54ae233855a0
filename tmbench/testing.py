"""Cells cut to a size the CPU tests can run (never used by a benchmark
run): the cell's own traffic kind and files, with its family's ``TINY``
merged into the configuration and its kind's ``TINY_PARAMS`` into the
parameters."""
from __future__ import annotations

import dataclasses
from pathlib import Path

from tmbench import harness


def tiny(cell, root: Path = harness.ROOT):
    """``cell`` at the tests' size (its files found under ``root``)."""
    family = harness.family_module(harness.family_of(cell.config), root)
    kind = harness.kind_module(cell.kind, root)
    return dataclasses.replace(cell, config={**cell.config, **family.TINY},
                               params={**cell.params, **kind.TINY_PARAMS})
