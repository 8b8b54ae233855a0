"""Open-loop load generation and the ``sustained_load`` record (port of
``repro.serving.loadgen``; numpy and the port's servers, no JAX).

Production load is open-loop: arrivals are a Poisson process that does not
wait for earlier requests to complete. This module submits on that
schedule (sleeping to each arrival time, bursting every due request),
sweeps a ladder of offered rates, and reports per step the offered and
achieved throughput, completion p50/p95/p99, the rejection rate (typed
``Overloaded`` admissions), and the **knee**: the highest offered rate the
server still holds (achieved ≥ 0.8 × offered with ≤ 1% rejections).

The generator shares the host, and the interpreter lock, with the server's
dispatch and result threads, so it may fall behind its own schedule at high
rates. Each step therefore also records ``submitted_rps``, the rate at
which the requests were actually submitted (the port's one key beyond the
reference's record): where it falls short of ``offered_rps``, the
generator, not the server, limits the step.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.serving.runtime import AsyncTMServer, ScoreResult


def poisson_arrivals(rps: float, duration_s: float,
                     rng: np.random.Generator) -> np.ndarray:
    """Arrival offsets (seconds, ascending) of a Poisson process at
    ``rps`` over ``duration_s`` — at least one arrival."""
    n = max(1, int(round(rps * duration_s)))
    gaps = rng.exponential(1.0 / rps, n)
    arrivals = np.cumsum(gaps)
    return arrivals[arrivals <= duration_s] if arrivals.size > 1 else arrivals


def run_step(server: AsyncTMServer, xs: np.ndarray, *, rps: float,
             duration_s: float, rng: np.random.Generator,
             tenant_of=None, wait_timeout: float = 60.0) -> dict:
    """Offer one open-loop Poisson step to a running server.

    Submissions happen on the arrival schedule regardless of completions
    (the open-loop property); after the last arrival the step drains and
    summarises. ``xs`` is a pool of request rows cycled per arrival;
    ``tenant_of(i)`` names the tenant of arrival ``i`` (default: one
    tenant).
    """
    arrivals = poisson_arrivals(rps, duration_s, rng)
    n = arrivals.size
    before = server.stats()
    promises = []
    t0 = time.perf_counter()
    i = 0
    while i < n:
        now = time.perf_counter() - t0
        if arrivals[i] > now:
            time.sleep(min(arrivals[i] - now, 0.005))
            continue
        while i < n and arrivals[i] <= now:  # burst every due arrival
            tenant = tenant_of(i) if tenant_of is not None else "default"
            promises.append(server.submit(xs[i % len(xs)], tenant=tenant))
            i += 1
    submitted_s = time.perf_counter() - t0
    server.drain(timeout=wait_timeout)
    results = [p.wait(wait_timeout) for p in promises]
    after = server.stats()

    done = [r for r in results if isinstance(r, ScoreResult)]
    rejected = len(results) - len(done)
    lat_ms = np.asarray([r.latency_s for r in done]) * 1e3 if done else None
    last_done = max((r.done_s for r in done), default=t0)
    elapsed = max(last_done - t0, 1e-9)
    batches = after["batches"] - before["batches"]
    rows_padded = after["rows_padded"] - before["rows_padded"]
    step = {
        "offered_rps": round(n / max(float(arrivals[-1]), 1e-9), 1),
        "achieved_rps": round(len(done) / elapsed, 1),
        "requests": n,
        "completed": len(done),
        "rejected": rejected,
        "rejection_rate": round(rejected / n, 4),
        "batches": batches,
        "mean_batch": round(len(done) / batches, 2) if batches else 0.0,
        "padding_efficiency": round(
            (after["rows_real"] - before["rows_real"]) / rows_padded, 4)
        if rows_padded else 1.0,
        "submitted_rps": round(n / max(submitted_s, 1e-9), 1),
    }
    if lat_ms is not None:
        p50, p95, p99 = np.percentile(lat_ms, [50, 95, 99])
        step["latency_ms"] = {"p50": round(float(p50), 3),
                              "p95": round(float(p95), 3),
                              "p99": round(float(p99), 3),
                              "mean": round(float(lat_ms.mean()), 3)}
    return step


def holds(step: dict) -> bool:
    """Did the server sustain this step's offered load?

    Primary signal: rejections ≤ 1% — with a bounded backlog, a rate past
    capacity fills the budget and turns into typed rejections within a
    step. Secondary guard: achieved ≥ 0.8 × offered, which catches a
    just-past-capacity step whose backlog did not fill before the step
    ended. The factor is 0.8 (not ~1.0) because ``achieved_rps`` divides
    by an elapsed time that includes the final batch's drain tail, biasing
    the ratio low on short steps even when the server kept up.
    """
    return (step["rejection_rate"] <= 0.01
            and step["achieved_rps"] >= 0.8 * step["offered_rps"])


def find_knee(steps: list[dict]) -> dict:
    """The knee of an offered-vs-achieved curve (steps in offered order).

    The knee is the last step that ``holds``; when nothing holds (every
    step already past capacity) it falls back to the max-achieved step,
    named in ``criterion``.
    """
    holding = [i for i, s in enumerate(steps) if holds(s)]
    if holding:
        i = holding[-1]
        criterion = "last step with achieved >= 0.8*offered and <=1% rejected"
    else:
        i = int(np.argmax([s["achieved_rps"] for s in steps]))
        criterion = "no step held offered load; max achieved"
    return {"index": i, "offered_rps": steps[i]["offered_rps"],
            "achieved_rps": steps[i]["achieved_rps"],
            "criterion": criterion}


def sustained_load(server: AsyncTMServer, xs: np.ndarray, *,
                   rps_steps, step_duration_s: float = 0.5,
                   seed: int = 0, tenant_of=None) -> dict:
    """Sweep an offered-rate ladder against a server; the schema-2
    ``sustained_load`` record (without the sync baseline the caller adds).

    Starts the server if needed, runs every step open-loop back to back,
    and checks the bucket cache's hot-loop invariant: nothing was prepared
    after startup (``lowerings`` constant) and nothing missed (``misses``
    zero); a violation raises ``RuntimeError``.
    """
    rng = np.random.default_rng(seed)
    server.start()
    lowerings_before = server.aot.counters()["lowerings"]
    steps = [run_step(server, xs, rps=float(rps),
                      duration_s=step_duration_s, rng=rng,
                      tenant_of=tenant_of)
             for rps in rps_steps]
    aot = server.aot.counters()
    hot_loop_compiles = aot["lowerings"] - lowerings_before
    if hot_loop_compiles or aot["misses"]:
        raise RuntimeError(
            f"bucket-cache invariant violated: {hot_loop_compiles} entries "
            f"prepared and {aot['misses']} misses inside the timed loop")
    stats = server.stats()
    return {
        "open_loop": True,
        "engine": server.engine,
        "step_duration_s": step_duration_s,
        "steps": steps,
        "knee": find_knee(steps),
        "tenants": stats["tenants"],
        "aot": {**aot, "hot_loop_compiles": hot_loop_compiles},
    }
