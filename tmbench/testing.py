"""Cells cut to a size the CPU tests can run (never used by a benchmark
run): the cell's own traffic kind and files, at a few clauses and
features, a short pool and small batches."""
from __future__ import annotations

import dataclasses

TINY = {"n_classes": 3, "n_clauses": 32, "n_features": 16, "threshold": 5,
        "avg_clause_len": 4}
TINY_PARAMS = {
    "open_loop": {"rate_rps": 300, "pool_rows": 64, "warm_seconds": 0.1,
                  "trace_seconds": 0.2},
    "offline_score": {"pool_rows": 300, "batch": 64, "trace_batches": 3},
    "online_train": {"pool_rows": 200, "batch": 8,
                     "max_events_per_batch": 4096, "tail_steps": 1,
                     "trace_steps": 2},
}


def tiny(cell):
    """``cell`` at the tests' size."""
    config = {**cell.config, **TINY}
    params = {**cell.params, **TINY_PARAMS.get(cell.kind, {})}
    return dataclasses.replace(cell, config=config, params=params)
