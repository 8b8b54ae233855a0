"""Online learning: ``TsetlinMachine(engines=("indexed",)).partial_fit``
in sequential steps of a fixed batch, cycling over a host pool of labelled
rows, from a trained-like state; the machine draws from its own generator
seeded from the run's seed.

Parameters (the cell's file): ``pool_rows``, ``batch``,
``max_events_per_batch`` (the event buffer, sized once by a probe run),
``warm_steps`` (the first steps, run in set-up through the window's own
call), ``tail_steps`` (how often the window keeps the machine's TA states:
the reference replays from the older of the last two it kept),
``trace_steps`` (the traced slice, right after the window).

Judged once the window and the traced slice have closed, by the reference
replaying the machine's steps with its own draws:

* the start: set-up's steps from the benchmark's own starting states,
  against the machine's TA states, index lists (as sets) and counts after
  them;
* the tail: from the TA states the window kept ``tail_steps`` to twice
  that many steps before its end (its draws skipped to there), every step
  to the last of the traced slice, against the machine's final TA states,
  lists and counts, and its event overflow against none.

The tail's length, and so the reference's time, does not grow with the
machine's speed; only skipping the draws does, at a few ms a step.
"""
from __future__ import annotations

import time

import torch

from tmbench import counts
from tmbench import gen as G
from tmbench import judge
from tmbench.reference import tm as ref
from tmbench.trace import Slice, per_second

# the planted faults a cell of this kind can have (tmbench/control.py)
FAULTS = ("unchanged", "half_batch", "altered")
# the CPU tests' parameters (tmbench/testing.py)
TINY_PARAMS = {"pool_rows": 200, "batch": 8,
               "max_events_per_batch": 4096, "tail_steps": 1,
               "trace_steps": 2}


def hyper(cfg) -> dict:
    """The reference's hyper-parameters from the configuration."""
    return {"n_states": cfg.n_states, "s": cfg.s, "threshold": cfg.threshold,
            "boost_true_positive": cfg.boost_true_positive}


def snapshot(machine) -> dict:
    """The program's outputs, kept on the host for judging."""
    bundle = machine.bundle
    index = bundle.index
    n = bundle.state.ta_state.shape[1]
    counts_ = index.counts.to("cpu", copy=True)
    return {"ta": bundle.state.ta_state.to("cpu", copy=True),
            "mult": judge.list_multiplicity(index.lists.cpu(), counts_, n),
            "counts": counts_,
            "overflow": int(bundle.event_overflow)}


def wrong(snap: dict, ta: torch.Tensor, n_states: int) -> dict:
    """How far a snapshot lies from the reference's states ``ta``."""
    inc = ta > n_states
    return {"ta": int((snap["ta"].to(ta.device) != ta).sum()),
            "lists": judge.lists_wrong(snap["mult"], inc),
            "counts": judge.counts_wrong(snap["counts"], inc)}


def run(ctx) -> dict:
    """Set up the machine on the seed's trained-like state, warm it up,
    learn for the window and the traced slice, then replay the start and
    the tail in the reference and judge them."""
    from torch.profiler import record_function

    from repro_torch.core.session import TsetlinMachine
    from repro_torch.core.types import TMState

    cfg, conf, p = ctx.cfg, ctx.cell.config, ctx.cell.params
    dev = ctx.device
    _, include = G.served_inputs(ctx)
    ta0 = G.trained_like_state(include, cfg.n_states,
                               G.generator(ctx.seed, "depths", dev))
    x, y = G.dataset(conf["data"], p["pool_rows"], cfg.n_features,
                     cfg.n_classes, G.generator(ctx.seed, "rows", dev))
    ratio = counts.work_ratio(include, x[:1024])
    del include
    x_host, y_host = G.host_rows(x), G.host_rows(y)
    del x, y
    ta0_host = ta0.to("cpu", copy=True)
    b = p["batch"]
    n_batches = p["pool_rows"] // b
    machine_seed = G.sub_seed(ctx.seed, "machine")

    def rows(step: int):
        a = (step % n_batches) * b
        return x_host[a:a + b], y_host[a:a + b]

    ctx.reset_peak()
    ctx.build()
    machine = TsetlinMachine(cfg, engines=("indexed",), device=dev,
                             max_events_per_batch=p["max_events_per_batch"],
                             seed=machine_seed)
    machine.bundle = machine.session.prepare(TMState(ta_state=ta0))
    del ta0
    step = 0
    for _ in range(p["warm_steps"]):
        machine.partial_fit(*rows(step))
        step += 1
    start = snapshot(machine)
    kept = [(step, start["ta"])]        # (step, TA states after it): the last two
    t0 = ctx.open_window()
    first = step
    ends = []
    while True:
        machine.partial_fit(*rows(step))
        step += 1
        if (step - first) % p["tail_steps"] == 0:
            kept = [kept[-1], (step, machine.bundle.state.ta_state.to("cpu"))]
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= ctx.seconds:
            break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t0
    samples = (step - first) * b
    trace = None
    traced = 0
    if ctx.trace:
        Slice.warm(dev)
        with Slice(dev) as sl:
            for _ in range(p["trace_steps"]):
                with record_function("tmbench.partial_fit"):
                    machine.partial_fit(*rows(step))
                step += 1
                traced += 1
        trace = sl.summary()
    peak = ctx.peak()
    end = snapshot(machine)
    del machine
    ctx.free()

    t_ref = time.perf_counter()
    draws = ref.Draws(cfg.n_classes, cfg.n_clauses, cfg.n_literals,
                      machine_seed, dev)
    hp = hyper(cfg)

    def replay(ta: torch.Tensor, steps: range, stats=None) -> torch.Tensor:
        for s in steps:
            xb, yb = rows(s)
            ref.learn_step(ta, torch.from_numpy(xb), [int(v) for v in yb],
                           draws, hp, stats=stats if s >= step - traced else None)
        return ta

    warm = p["warm_steps"]
    at_start = wrong(start, replay(ta0_host.to(dev, copy=True), range(warm)),
                     cfg.n_states)
    tail_from, tail_ta = kept[0]
    draws.skip(tail_from - warm, b)
    stats: list = []
    at_end = wrong(end, replay(tail_ta.to(dev, copy=True),
                               range(tail_from, step), stats), cfg.n_states)
    upd_s, learn_s = traced_bounds(cfg.n_clauses, cfg.n_literals,
                                   [r.tolist() for r in stats])
    ctx.log(f"window: {step - first - traced} steps of {b} in {window_s:.3f} s "
            f"(closed loop: no schedule to run late against); work ratio of "
            f"the first 1024 rows on the starting state {ratio:.6f}; the "
            f"reference replayed steps 0-{warm - 1} and {tail_from}-{step - 1} "
            f"of {step} in {time.perf_counter() - t_ref:.3f} s; steps ending "
            f"in each second of the window {per_second(ends)}")
    return {"attempted": samples, "failed": 0,
            "compared": {"start_wrong": (sum(at_start.values()), 0),
                         "ta_cells_wrong": (at_end["ta"], 0),
                         "list_cells_wrong": (at_end["lists"], 0),
                         "counts_wrong": (at_end["counts"], 0),
                         "event_overflow": (end["overflow"], 0)},
            "memory_peak_bytes": peak,
            "data": {"samples": samples, "window_s": window_s,
                     "traced_update_bound_s": upd_s,
                     "traced_learn_bound_s": learn_s},
            "trace": trace}


def traced_bounds(n: int, two_o: int, rounds: list) -> tuple[float, float]:
    """``(ta_update_bound_s, learning_bound_s)`` summed over class rounds
    given as (Type I rows, rows read, states changed), as the reference's
    replay of the traced slice counts them."""
    upd = learn = 0.0
    for type_i_rows, read_rows, changed in rounds:
        upd += counts.bound_s(*counts.ta_update_work(n, two_o, type_i_rows))
        learn += counts.round_bytes(n, two_o, read_rows, changed) / counts.PEAK_BYTES_PER_S
    return upd, learn
