#!/usr/bin/env python3
"""Single-device learning-step times of the port, for one tree or for two
trees taking turns, on one NVIDIA GPU.

    python3 scripts/time_train_step.py
    python3 scripts/time_train_step.py --tree parent=DIR \\
        --order parent,this,this,parent

``this`` is the tree that holds this script; ``--tree NAME=DIR`` names
another checkout of the repository (for example the parent commit, unpacked
with ``git archive`` into a directory that ``.gitignore`` lists). Each run
is a fresh process that imports ``repro_torch`` from its tree's ``src``
(both packages have that name), builds that tree's kernels into its own
``build/``, and, at the ``tm_mnist`` width (m=10, n=2000, o=784) from
chip_smoke.py's trained-like state with B=32, times:

  * ``feedback``: ``tm.update_batch_sequential`` and
    ``tm.update_batch_parallel`` alone (the class rounds of a batch), each
    step from the same state;
  * ``partial_fit``: ``TsetlinMachine.partial_fit`` in each learning mode
    (rounds, event diff and cache sync), steps in a row;

``--steps`` steps after one warm-up step, host wall time between device
synchronisations, all on the same injected draws and inputs in every tree.
Each run prints one JSON line; at the end come the medians per tree, the
card's name and power limit, and a check that every tree reached the same
states. The whole record goes to ``chiprun_out/time_train_step.json``.

Imports no JAX.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEED = 0
BATCH = 32
MODES = ("sequential", "parallel")


def _digest(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def run_child(src: Path, steps: int) -> dict:
    """Time the tree under ``src`` (this process imports its ``repro_torch``)."""
    sys.path[:0] = [str(src), str(ROOT)]   # ROOT: chip_smoke's state helpers
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs.tm import PAPER_TM_CONFIGS
    from repro_torch.core import tm
    from repro_torch.core.session import TsetlinMachine
    from repro_torch.core.types import TMState, include_mask
    from repro_torch.data.synthetic import templated_images
    from repro_torch.kernels import _build

    if not Path(tm.__file__).resolve().is_relative_to(src.resolve()):
        raise RuntimeError(f"imported {tm.__file__}, not the tree under {src}")
    _build.build_all()
    exp = PAPER_TM_CONFIGS["tm_mnist"]
    cfg, dev = exp.tm, torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    _, inc = cs.served_state(cfg, int(exp.avg_clause_len), gen, dev)
    ta0 = cs.trained_like_state(cfg, inc, gen, dev)
    rng = np.random.default_rng(SEED)
    templates = rng.uniform(size=(cfg.n_classes, cfg.n_features)) < 0.3
    xs, ys = templated_images(templates, BATCH * (steps + 1), rng=rng)
    batches = [(xs[i * BATCH:(i + 1) * BATCH], ys[i * BATCH:(i + 1) * BATCH])
               for i in range(steps + 1)]
    draws = [tm.draw_sample_draws(cfg, torch.Generator(device=dev)
                                  .manual_seed(SEED + 1 + i), BATCH)
             for i in range(steps + 1)]
    probe = tm.update_batch_sequential(cfg, TMState(ta0), *batches[0], draws[0])
    crossings = int((include_mask(cfg, probe) != (ta0 > cfg.n_states)).sum())
    max_events = max(1024, 1 << (4 * crossings - 1).bit_length())

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    out = {"src": str(src), "feedback_ms": {}, "partial_fit_ms": {},
           "digests": {}}
    for mode, update in zip(MODES, (tm.update_batch_sequential,
                                    tm.update_batch_parallel)):
        got = {}
        times = [timed(lambda: got.__setitem__(
            i, update(cfg, TMState(ta0), *batches[i], draws[i])))
            for i in range(steps + 1)]
        out["feedback_ms"][mode] = times[1:]
        out["digests"][f"feedback_{mode}"] = _digest(got[steps].ta_state)
    for mode in MODES:
        machine = TsetlinMachine(cfg, engines=("indexed", "bitpack", "dense"),
                                 device=dev, parallel=mode == "parallel",
                                 max_events_per_batch=max_events)
        machine.bundle = machine.session.prepare(TMState(ta_state=ta0))
        times = [timed(lambda i=i: machine.partial_fit(*batches[i], draws[i]))
                 for i in range(steps + 1)]
        if machine.event_overflow != 0:
            raise RuntimeError(f"{mode}: event_overflow {machine.event_overflow}")
        out["partial_fit_ms"][mode] = times[1:]
        out["digests"][f"partial_fit_{mode}"] = _digest(machine.state.ta_state)
    out["max_events"] = max_events
    return out


def card_line() -> str:
    """``name, power.limit`` as nvidia-smi prints them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "nvidia-smi not available"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR: another checkout to time")
    ap.add_argument("--order", default="this",
                    help="comma-separated tree names, one run each, in turn")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        print(json.dumps(run_child(Path(args.child), args.steps)))
        return 0
    trees = {"this": ROOT}
    for spec in args.tree:
        name, _, path = spec.partition("=")
        trees[name] = Path(path).resolve()
    runs = []
    for name in args.order.split(","):
        proc = subprocess.run(
            [sys.executable, __file__, "--child", str(trees[name] / "src"),
             "--steps", str(args.steps)], capture_output=True, text=True,
            timeout=900)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, sep="\n", file=sys.stderr)
            raise RuntimeError(f"run of tree {name!r} failed")
        run = dict(json.loads(proc.stdout.strip().splitlines()[-1]), tree=name)
        runs.append(run)
        print(json.dumps(run))
    card = card_line()
    summary = {}
    for name in dict.fromkeys(r["tree"] for r in runs):
        mine = [r for r in runs if r["tree"] == name]
        summary[name] = {
            f"{kind}_{mode}_median_ms": statistics.median(
                t for r in mine for t in r[f"{kind}_ms"][mode])
            for kind in ("feedback", "partial_fit") for mode in MODES}
    digests = {json.dumps(r["digests"], sort_keys=True) for r in runs}
    record = {"card": card, "batch": BATCH, "steps": args.steps,
              "summary": summary, "same_states": len(digests) == 1,
              "runs": runs}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "time_train_step.json").write_text(json.dumps(record, indent=1))
    for name, row in summary.items():
        print(f"{name}: " + ", ".join(f"{k} {v:.3f}" for k, v in row.items())
              + f" [{card}]")
    print(f"same states in every run: {record['same_states']}")
    return 0 if record["same_states"] else 1


if __name__ == "__main__":
    sys.exit(main())
