"""The LM family's control and planted faults, by name; not part of a
benchmark run:

    python3 -m tmbench.lm_control --workload <cell> --mode <mode> \\
        --seeds 1 2 3 [--seconds 3] [--out lm_control.jsonl]

runs an LM cell once per seed in one process with the program's path as
its family's ``mode`` puts it, ``--mode`` one of ``program``, ``control``
(as ``tmbench.control`` runs them) or a fault of the family's ``FAULTS``
(``tmbench/families/lm.py``), which ``tmbench.control``'s modes do not
name, and prints each run's compared numbers as a JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def modes(cell, root: Path = ROOT) -> tuple[str, ...]:
    """``program``, ``control`` and the cell's family's faults."""
    from tmbench import harness

    family = harness.family_module(harness.family_of(cell.config), root)
    return ("program", "control") + tuple(family.FAULTS)


def run(cell, which: str, seeds, seconds: float, device, root: Path = ROOT):
    """Yield ``(seed, result line)`` of ``cell`` run once per seed under its
    family's ``mode(kind, which)``."""
    from tmbench import harness

    if which not in modes(cell, root):
        raise ValueError(f"mode {which!r}; one of {modes(cell, root)}")
    family = harness.family_module(harness.family_of(cell.config), root)
    for seed in seeds:
        with family.mode(cell.kind, which):
            line = harness.run_cell(cell, seed, seconds, False, device,
                                    time.perf_counter(), root)
        yield seed, line


def main(argv=None) -> int:
    """See the module docstring."""
    parser = argparse.ArgumentParser(prog="python3 -m tmbench.lm_control")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--mode", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from tmbench import harness

    torch.backends.cuda.matmul.allow_tf32 = False
    cell = harness.cell_from_files(args.workload)
    print(f"card: {harness.card_line()}", file=sys.stderr)
    rows = [{"workload": cell.name, "mode": args.mode, "seed": seed,
             "correct": line["correct"], "compared": line["compared"],
             "memory_peak_bytes": line["device"]["memory_peak_bytes"]}
            for seed, line in run(cell, args.mode, args.seeds, args.seconds,
                                  torch.device(args.device))]
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
