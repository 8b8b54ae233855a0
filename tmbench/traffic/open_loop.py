"""Open-loop serving: single rows arrive on a Poisson schedule at a fixed
rate, from independent clients of several tenants, into ``AsyncTMServer``.

Parameters (the cell's file): ``rate_rps``; ``tenants`` (name → share of
the arrivals); ``pool_rows`` request rows made from the seed, each the
base rows (``base``: ``bits`` or ``data``) with one random
clause made true; ``max_batch`` (the server's top bucket); ``warm_seconds`` of the same
load offered in set-up before the window, whose answers are not judged
(a process's first seconds of serving run slower); ``trace_at`` and
``trace_seconds`` (the traced slice, as a share of the window and in
seconds).

The schedule: ``rate · seconds`` arrivals whose gaps are the exponential
distribution's quantiles in an order drawn from the seed, so every seed
offers the same arrivals over exactly the window, in another order; each
arrival's row and tenant are drawn from the seed too. Each request is
timed from when it was due to its ``ScoreResult``. A request that fails
(refused as ``Overloaded``, or an error) counts as failed and, in the
latency set, at the window's length.
"""
from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

from tmbench import counts
from tmbench import gen as G
from tmbench.reference import tm as ref
from tmbench.trace import Slice

WAIT_S = 60.0        # how long past the window an answer may come

# the planted faults a cell of this kind can have (tmbench/control.py)
FAULTS = ("half_batch", "altered")
# the CPU tests' parameters (tmbench/testing.py)
TINY_PARAMS = {"rate_rps": 300, "pool_rows": 64, "warm_seconds": 0.1,
               "trace_seconds": 0.2}


def schedule(rate: float, seconds: float, tenants: dict, pool_rows: int,
             seed: int) -> dict:
    """Arrival offsets (s), pool row and tenant of every arrival."""
    n = max(1, int(round(rate * seconds)))
    rng = np.random.default_rng(G.sub_seed(seed, "arrivals"))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q)
    gaps *= seconds / gaps.sum()
    rng.shuffle(gaps)
    names = sorted(tenants)
    shares = np.asarray([tenants[t] for t in names], dtype=np.float64)
    per = np.floor(n * shares / shares.sum()).astype(int)
    per[0] += n - per.sum()
    who = np.repeat(np.arange(len(names)), per)
    rng.shuffle(who)
    return {"arrivals": np.cumsum(gaps), "row": rng.integers(0, pool_rows, n),
            "tenant": [names[i] for i in who]}


@contextlib.contextmanager
def collector_paused():
    """Python's cyclic garbage collector off for the block (what exists
    before it frozen out of later collections). The window keeps every
    answer for judging, and collections over that growing heap stall every
    thread of the process, the server's and the generator's, for up to
    hundreds of milliseconds; a client of the server holds no such heap."""
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.unfreeze()


def drive(server, pool: np.ndarray, sched: dict, on_tick=None) -> dict:
    """Submit every arrival when due (bursting what is due), then wait for
    every answer; ``on_tick(now)`` runs between arrivals."""
    arrivals, rows, tenant = sched["arrivals"], sched["row"], sched["tenant"]
    n = arrivals.size
    promises = [None] * n
    late = np.empty(n)
    clock = time.perf_counter
    t0 = clock()
    i = 0
    while i < n:
        now = clock() - t0
        if arrivals[i] > now:
            if on_tick is not None:
                on_tick(now)
            time.sleep(min(arrivals[i] - now, 0.002))
            continue
        while i < n and arrivals[i] <= now:
            promises[i] = server.submit(pool[rows[i]], tenant=tenant[i])
            late[i] = clock() - t0 - arrivals[i]
            i += 1
    submitted = clock()
    results = []
    for p in promises:
        try:
            results.append(p.wait(max(0.0, submitted + WAIT_S - clock())))
        except TimeoutError:
            results.append(None)
        except Exception as e:  # noqa: BLE001 — an answer that is an error
            results.append(e)
    return {"t0": t0, "results": results, "late": late}


def outcome(run: dict, sched: dict, window_ms: float):
    """``(latency_ms, done_idx, done_scores, refused, errors, missing)``:
    every request's latency from its due time (failed ones at
    ``window_ms``), and the answers that came."""
    from repro_torch.serving.runtime import Overloaded, ScoreResult

    t0, arrivals = run["t0"], sched["arrivals"]
    lat = np.full(arrivals.size, float(window_ms), dtype=np.float64)
    done_idx, done_scores = [], []
    refused = errors = missing = 0
    for i, r in enumerate(run["results"]):
        if isinstance(r, ScoreResult):
            lat[i] = (r.done_s - (t0 + arrivals[i])) * 1e3
            done_idx.append(i)
            done_scores.append(np.asarray(r.scores))
        elif isinstance(r, Overloaded):
            refused += 1
        elif r is None:
            missing += 1
        else:
            errors += 1
    scores = (np.stack(done_scores) if done_scores
              else np.zeros((0, 0), np.int32))
    return lat, np.asarray(done_idx, dtype=np.int64), scores, refused, errors, missing


def stats_delta(before: dict, after: dict) -> dict:
    """The server's counters over the window."""
    return {k: after[k] - before[k] for k in ("batches", "rows_real",
                                              "rows_padded", "completed")}


def run(ctx) -> dict:
    """Set up the server on the seed's state, warm every bucket and the
    threads, offer the window's arrivals, then judge every answer."""
    from repro_torch.core.session import TMSession
    from repro_torch.core.types import TMState
    from repro_torch.serving.runtime import AsyncTMServer

    p = ctx.cell.params
    ta, include = G.served_inputs(ctx)
    pool_dev = G.request_pool(ctx, include, p)
    pool = G.host_rows(pool_dev)
    ratio = counts.work_ratio(include, pool_dev)
    include_host = include.to("cpu", copy=True)
    del include, pool_dev
    sched = schedule(p["rate_rps"], ctx.seconds, p["tenants"], p["pool_rows"],
                     ctx.seed)

    ctx.reset_peak()
    ctx.build()
    session = TMSession(ctx.cfg, engines=("indexed",), device=ctx.device)
    bundle = session.prepare(TMState(ta_state=ta))
    del ta
    server = AsyncTMServer(session, bundle, engine="indexed",
                           max_batch=p["max_batch"]).start()
    try:
        warm = schedule(p["rate_rps"], p["warm_seconds"], p["tenants"],
                        p["pool_rows"], G.sub_seed(ctx.seed, "warm"))
        with collector_paused():
            drive(server, pool, warm)
        server.drain(WAIT_S)
        before = server.stats()
        slice_ = None
        if ctx.trace:
            Slice.warm(ctx.device)
            slice_ = Slice(ctx.device)
        span = {"start": ctx.seconds * p["trace_at"], "on": None,
                "done": False}

        def tick(now):
            if slice_ is None or span["done"]:
                return
            if span["on"] is None and now >= span["start"]:
                slice_.start()
                span["on"] = time.perf_counter()
            elif (span["on"] is not None
                  and time.perf_counter() - span["on"] >= p["trace_seconds"]):
                slice_.stop()
                span["done"] = True

        with collector_paused():
            ctx.open_window()
            result = drive(server, pool, sched, on_tick=tick)
        if span["on"] is not None and not span["done"]:
            slice_.stop()
            span["done"] = True
        server.drain(WAIT_S)
        after = server.stats()
    finally:
        server.stop()
    peak = ctx.peak()
    del server, bundle, session
    ctx.free()

    window_ms = ctx.seconds * 1e3
    lat, done_idx, got, refused, errors, missing = outcome(result, sched,
                                                           window_ms)
    late = result["late"]
    second = np.minimum(sched["arrivals"], ctx.seconds - 1e-9).astype(int)
    p95s = [round(float(np.percentile(lat[second == k], 95)), 3)
            for k in range(int(np.ceil(ctx.seconds))) if (second == k).any()]
    ctx.log(f"p95 ms of the requests due in each second {p95s}")
    ctx.log(f"generator: {late.size} arrivals, late p95 "
            f"{np.percentile(late, 95) * 1e3:.4f} ms, max {late.max() * 1e3:.4f} "
            f"ms against the schedule; work ratio of the pool {ratio:.6f}")
    t_ref = time.perf_counter()
    want = ref.scores(include_host.to(ctx.device),
                      torch.from_numpy(pool).to(ctx.device)).cpu().numpy()
    wrong = (int((got != want[sched["row"][done_idx]]).any(1).sum())
             if len(done_idx) else 0)
    ctx.log(f"reference: {time.perf_counter() - t_ref:.3f} s")
    attempted = int(lat.size)
    return {"attempted": attempted, "failed": refused + errors + missing,
            "compared": {"wrong_scores": (wrong, 0),
                         "unanswered": (errors + missing, 0)},
            "memory_peak_bytes": peak,
            "data": {"latency_ms": lat, "stats": stats_delta(before, after)},
            "trace": slice_.summary() if slice_ is not None and span["done"] else None}
