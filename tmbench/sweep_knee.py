"""The knee of an open-loop serving cell, found once on the chip:

    python3 -m tmbench.sweep_knee --workload mnist_serve --seed 7 \\
        --rates 6000 8000 10000 12000 14000 16000 --step-seconds 10

Sets the cell up once (its state, its request pool, its server), then
offers each rate of the ladder for a step as long as the benchmark's
window, through the benchmark's own schedule and driver. A step holds
when at most 1% of its requests were refused and the rate achieved is at
least 0.8 of the rate offered (the port's ``holds`` rule, copied); the
knee is the last step before the first that does not hold (near capacity
a step can hold after one that did not: the boundary lies between them).
Prints one JSON line per step and the knee, and writes them to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def holds(step: dict) -> bool:
    """At most 1% refused and achieved at least 0.8 × offered."""
    return (step["refused_share"] <= 0.01
            and step["achieved_rps"] >= 0.8 * step["offered_rps"])


def main(argv=None) -> int:
    """See the module docstring."""
    parser = argparse.ArgumentParser(prog="python3 -m tmbench.sweep_knee")
    parser.add_argument("--workload", default="mnist_serve")
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--rates", type=float, nargs="+", required=True)
    parser.add_argument("--step-seconds", type=float, default=10.0)
    parser.add_argument("--out", default="chiprun_out/knee.json")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.core.session import TMSession
    from repro_torch.core.types import TMState
    from repro_torch.serving.runtime import AsyncTMServer

    from tmbench import gen as G
    from tmbench import harness
    from tmbench.traffic import open_loop

    cell = harness.cell_from_files(args.workload)
    family = harness.family_of(cell.config)
    if family != "tm":
        raise SystemExit(f"tmbench.sweep_knee: {cell.name} is a cell of "
                         f"family {family!r}; this tool runs family 'tm' only")
    dev = torch.device(args.device)
    ctx = harness.Context(cell=cell,
                          cfg=harness.family_module(family).config(cell.config),
                          seed=args.seed, seconds=args.step_seconds,
                          trace=False, device=dev, started=time.perf_counter())
    p = cell.params
    ta, include = G.served_inputs(ctx)
    pool = G.host_rows(G.request_pool(ctx, include, p))
    del include
    ctx.build()
    session = TMSession(ctx.cfg, engines=("indexed",), device=dev)
    server = AsyncTMServer(session, session.prepare(TMState(ta_state=ta)),
                           engine="indexed", max_batch=p["max_batch"]).start()
    card = harness.card_line()
    steps = []
    try:
        for k, rate in enumerate(args.rates):
            sched = open_loop.schedule(rate, args.step_seconds, p["tenants"],
                                       p["pool_rows"], args.seed + k)
            before = server.stats()
            with open_loop.collector_paused():
                run = open_loop.drive(server, pool, sched)
            server.drain(open_loop.WAIT_S)
            after = server.stats()
            lat, done, _, refused, errors, missing = open_loop.outcome(
                run, sched, args.step_seconds * 1e3)
            last = max((r.done_s for r in run["results"]
                        if hasattr(r, "done_s")), default=run["t0"])
            d = open_loop.stats_delta(before, after)
            n = lat.size
            step = {"offered_rps": rate,
                    "achieved_rps": len(done) / max(last - run["t0"], 1e-9),
                    "requests": n, "refused_share": refused / n,
                    "errors": errors + missing,
                    "p50_ms": float(np.percentile(lat, 50)),
                    "p95_ms": float(np.percentile(lat, 95)),
                    "late_p95_ms": float(np.percentile(run["late"], 95) * 1e3),
                    "late_max_ms": float(run["late"].max() * 1e3),
                    "batch_rows": d["rows_real"] / max(d["batches"], 1)}
            step["holds"] = holds(step)
            steps.append(step)
            print(json.dumps(step), flush=True)
    finally:
        server.stop()
    failed = [i for i, s in enumerate(steps) if not s["holds"]]
    held = steps[:failed[0]] if failed else steps
    knee = held[-1]["offered_rps"] if held else None
    record = {"workload": cell.name, "card": card,
              "step_seconds": args.step_seconds, "steps": steps,
              "knee_rps": knee, "rate_at_0.8": 0.8 * knee if knee else None}
    print(json.dumps({"knee_rps": knee, "card": card}), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
