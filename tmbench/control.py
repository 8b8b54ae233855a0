"""The control and the planted faults of the comparison that decides
``correct``, and the event-buffer probe; not part of a benchmark run.

    python3 -m tmbench.control --workload <cell> --mode <mode> --seeds 1 2 3 \\
        [--seconds 3] [--out chiprun_out/control.jsonl]

runs the cell once per seed in one process, with the program's path as
``--mode`` says, and prints each run's compared numbers as a JSON line:

* ``program`` — the program as it is (the lower readings);
* ``control`` — the reference put in the program's place in the precision
  below the configuration's;
* ``unchanged`` — a training step that does its work and returns the
  bundle it was given;
* ``half_batch`` — half of each batch left out (training: masked; scoring:
  the second half's scores dropped to zero);
* ``altered`` — one answer altered where it is produced (one score, or one
  TA state after each step).

The cell's family puts the program's path in each mode: its module
``tmbench/families/<family>.py`` gives ``mode(kind, which)``, a context
manager, and a family without one has no control and is refused. The
faults a cell can have are its traffic kind's ``FAULTS``.

``--mode probe_events`` instead runs training steps of a TM cell and
prints the boundary crossings of each step, counted from the states.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MODES = ("program", "control", "unchanged", "half_batch", "altered")
PROBE_EVENTS = 1 << 18    # the probe's buffer: its crossings are counted from the states


def faults_for(kind: str, root: Path = ROOT) -> tuple[str, ...]:
    """The planted faults a cell of this traffic kind can have."""
    from tmbench import harness

    return tuple(harness.kind_module(kind, root).FAULTS)


def run(cell_name: str, which: str, seeds, seconds: float, device,
        root: Path = ROOT, cell=None):
    """Yield ``(seed, result line)`` of the cell run once per seed, with
    the program's path as its family's ``mode`` puts it for ``which``."""
    from tmbench import harness

    if which not in MODES:
        raise ValueError(f"mode {which!r}; one of {MODES} or probe_events")
    cell = (harness.cell_from_files(cell_name, root) if cell is None
            else cell)
    family = harness.family_of(cell.config)
    module = harness.family_module(family, root)
    if not hasattr(module, "mode"):
        raise ValueError(f"{cell.name}: family {family!r} has no control: "
                         f"tmbench/families/{family}.py gives no "
                         "mode(kind, which)")
    for seed in seeds:
        with module.mode(cell.kind, which):
            line = harness.run_cell(cell, seed, seconds, False, device,
                                    time.perf_counter(), root)
        yield seed, line


def probe_events(cell, seeds, steps: int, device) -> list[dict]:
    """Per seed, each training step's boundary crossings, counted from the
    include masks before and after it."""
    import torch

    from repro_torch.core.session import TsetlinMachine
    from repro_torch.core.types import TMState

    from tmbench import gen as G
    from tmbench import harness

    family = harness.family_of(cell.config)
    if family != "tm":
        raise SystemExit(f"tmbench.control: {cell.name} is a cell of family "
                         f"{family!r}; --mode probe_events runs family 'tm' "
                         "only")
    cfg = harness.family_module(family).config(cell.config)
    out = []
    for seed in seeds:
        ctx = harness.Context(cell=cell, cfg=cfg, seed=seed, seconds=0,
                              trace=False, device=device, started=0.0)
        _, include = G.served_inputs(ctx)
        ta0 = G.trained_like_state(include, cfg.n_states,
                                   G.generator(seed, "depths", device))
        p = cell.params
        x, y = G.dataset(cell.config["data"], p["pool_rows"], cfg.n_features,
                         cfg.n_classes, G.generator(seed, "rows", device))
        x, y = G.host_rows(x), G.host_rows(y)
        b = p["batch"]
        machine = TsetlinMachine(cfg, engines=("indexed",), device=device,
                                 max_events_per_batch=PROBE_EVENTS,
                                 seed=G.sub_seed(seed, "machine"))
        machine.bundle = machine.session.prepare(TMState(ta_state=ta0))
        crossings = []
        for s in range(steps):
            before = machine.bundle.state.ta_state > cfg.n_states
            a = (s % (p["pool_rows"] // b)) * b
            machine.partial_fit(x[a:a + b], y[a:a + b])
            crossings.append(int((before != (machine.bundle.state.ta_state
                                              > cfg.n_states)).sum()))
        out.append({"seed": seed, "max": max(crossings), "crossings": crossings})
        del machine
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    """See the module docstring."""
    parser = argparse.ArgumentParser(prog="python3 -m tmbench.control")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--mode", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from tmbench import harness

    device = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = harness.cell_from_files(args.workload)
    print(f"card: {harness.card_line()}", file=sys.stderr)
    if args.mode == "probe_events":
        rows = probe_events(cell, args.seeds, args.steps, device)
    else:
        rows = [{"workload": cell.name, "mode": args.mode, "seed": seed,
                 "correct": line["correct"], "compared": line["compared"],
                 "metrics": line["metrics"]}
                for seed, line in run(cell.name, args.mode, args.seeds,
                                      args.seconds, device)]
    text = "\n".join(json.dumps(r) for r in rows)
    print(text, flush=True)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        with out.open("a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
