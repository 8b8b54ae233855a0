"""Offline scoring of a held test set: a host pool of rows scored through
``TsetlinMachine.scores`` in consecutive batches, each pass ending with
one ragged batch, every batch's scores brought back to the host.

Parameters (the cell's file): ``pool_rows`` (the rows, made from the seed
as the configuration's base rows with one random clause made true each),
``base`` (``bits`` or ``data``, the configuration's rows), ``batch``, ``trace_batches`` (the traced
slice after the window).

The window runs whole batches until ``seconds`` have passed; the rate is
the rows of every batch it ran over the time to the last one's scores on
the host. Every batch's scores are judged against the reference.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from tmbench import counts
from tmbench import gen as G
from tmbench.reference import tm as ref
from tmbench.trace import Slice, per_second

# the planted faults a cell of this kind can have (tmbench/control.py)
FAULTS = ("half_batch", "altered")
# the CPU tests' parameters (tmbench/testing.py)
TINY_PARAMS = {"pool_rows": 300, "batch": 64, "trace_batches": 3}


def batch_starts(pool_rows: int, batch: int) -> list[int]:
    """First row of every batch of one pass (the last may be ragged)."""
    return list(range(0, pool_rows, batch))


def run(ctx) -> dict:
    """Set up the machine on the seed's state, warm both batch shapes,
    score for the window, then judge every batch."""
    from torch.profiler import record_function

    from repro_torch.core.session import TsetlinMachine
    from repro_torch.core.types import TMState

    p = ctx.cell.params
    ta, include = G.served_inputs(ctx)
    pool_dev = G.request_pool(ctx, include, p)
    pool = G.host_rows(pool_dev)
    del pool_dev
    include_host = include.to("cpu", copy=True)
    del include
    starts = batch_starts(p["pool_rows"], p["batch"])
    b = p["batch"]

    ctx.reset_peak()
    ctx.build()
    machine = TsetlinMachine(ctx.cfg, engines=("indexed",), device=ctx.device,
                             seed=G.sub_seed(ctx.seed, "machine"))
    machine.bundle = machine.session.prepare(TMState(ta_state=ta))
    del ta

    def score(k: int) -> np.ndarray:
        a = starts[k % len(starts)]
        return machine.scores(pool[a:a + b]).cpu().numpy()

    for k in (0, len(starts) - 1) * 2:          # every shape the pass uses
        score(k)
    out = []
    t0 = ctx.open_window()
    k = rows = 0
    ends = []
    while True:
        got = score(k)
        out.append((k, got))
        rows += got.shape[0]
        k += 1
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    in_window = k
    trace = None
    if ctx.trace:
        Slice.warm(ctx.device)
        with Slice(ctx.device) as sl:
            for _ in range(p["trace_batches"]):
                with record_function("tmbench.score_batch"):
                    out.append((k, score(k)))
                k += 1
        trace = sl.summary()
    peak = ctx.peak()
    del machine
    ctx.free()

    t_ref = time.perf_counter()
    inc = include_host.to(ctx.device)
    x_all = torch.from_numpy(pool).to(ctx.device)
    want = ref.scores(inc, x_all).cpu().numpy()
    wrong = 0
    for j, got in out:
        a = starts[j % len(starts)]
        wrong += int((got != want[a:a + got.shape[0]]).any(1).sum())
    work = _batch_work(ctx, inc, x_all, starts, b)
    ctx.log(f"closed loop (no schedule to run late against); pool: "
            f"{p['pool_rows']} rows in {len(starts)} batches; work "
            f"ratio {work['ratio']:.6f}; {in_window} batches in the window; "
            f"reference and counts {time.perf_counter() - t_ref:.3f} s; "
            f"batches ending in each second {per_second(ends)}")
    return {"attempted": rows, "failed": 0,
            "compared": {"wrong_rows": (wrong, 0)},
            "memory_peak_bytes": peak,
            "data": {"rows": rows, "window_s": window_s,
                     "window_bound_s": sum(work["bound_s"][j % len(starts)]
                                           for j in range(in_window)),
                     "traced_walk_bound_s": sum(
                         work["walk_bound_s"][j % len(starts)]
                         for j in range(in_window, k))},
            "trace": trace}


def _batch_work(ctx, include: torch.Tensor, x: torch.Tensor,
                starts: list[int], b: int) -> dict:
    """Per batch of a pass: the least time of scoring it (falsifying
    inclusions against the logic peak, or its bytes) and of its list walk."""
    cfg = ctx.cfg
    lengths = counts.list_lengths(include)
    fals = counts.falsifying_inclusions(include, x)
    bound, walk = [], []
    for a in starts:
        xb = x[a:a + b]
        nbytes, ops, ids = counts.walk_work(lengths, xb, cfg.n_clauses)
        walk.append(counts.bound_s(nbytes, ops))
        sb, so = counts.score_batch_work(int(fals[a:a + b].sum()), xb.shape[0],
                                         cfg.n_features, cfg.n_classes, ids)
        bound.append(counts.bound_s(sb, so))
    ratio = float(fals.double().mean()) / counts.dense_work(
        cfg.n_classes, cfg.n_clauses, cfg.n_features)
    return {"bound_s": bound, "walk_bound_s": walk, "ratio": ratio}
