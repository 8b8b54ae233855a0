"""The benchmark's driver: finds a cell's configuration, traffic and
metrics by name, runs the cell once and builds the result line.

Everything that belongs to one piece sits in files of its own, found by
the names in ``BENCHMARK.json``:

* ``tmbench/workloads/<cell>.json`` — the cell's configuration name, its
  traffic mix's name, the traffic kind and that kind's parameters;
* ``tmbench/configs/<config>.json`` — the configuration's sizes and
  dtypes, its source, what was cut (``reduced``, with the ``published``
  value of each key cut), and its ``family`` (``tm`` where it names none);
* ``tmbench/families/<family>.py`` — one module per kind of model, with
  ``config(conf) -> object`` (what traffic kinds get as ``ctx.cfg``),
  ``TINY`` (its cut for the CPU tests), ``check(conf, entry)`` (its own
  invariants, on top of every configuration's contract, which the tests
  hold) and ``mode(kind, which)`` (the program's path under the control
  and each planted fault, for ``tmbench.control``);
* ``tmbench/traffic/<kind>.py`` — one general generator and driver per
  traffic kind, with ``run(ctx) -> record``, ``FAULTS`` (the planted
  faults its cells can have) and ``TINY_PARAMS`` (its parameters for the
  CPU tests);
* ``tmbench/metrics/<metric>.py`` — one reader per metric, with
  ``read(record) -> float | None`` (None: nothing to read here).

A record is ``{"attempted", "failed", "compared": {name: (value, limit)},
"data": {...}, "trace": slice summary or None, "memory_peak_bytes"}``;
the harness adds ``setup_s``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = "tmbench"
# modules that must not be loaded in the process that prints a result
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_age_s() -> float | None:
    """Seconds since this process started (from ``/proc``), or None."""
    try:
        stat = Path("/proc/self/stat").read_text()
        ticks = int(stat[stat.rindex(")") + 2:].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return None


def load_json(path: Path) -> dict:
    """A JSON file as a dict."""
    return json.loads(Path(path).read_text())


def _tag(path: Path) -> str:
    """A short tag of a file's absolute path (modules of two checkouts
    never share a name)."""
    import hashlib
    return hashlib.sha256(str(Path(path).resolve()).encode()).hexdigest()[:10]


def load_module(path: Path, name: str):
    """Import the Python file ``path`` as module ``name``."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not Path(path).is_file():
        raise FileNotFoundError(f"no module file {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One benchmark cell, resolved from its files."""

    name: str
    chips: int
    config: dict
    kind: str
    params: dict
    end_to_end: list
    per_layer: list


def metrics_for(bench: dict, cell: str) -> tuple[list, list]:
    """``(end_to_end, per_layer)`` metric entries a cell reports: those
    that list it, or list no cells (a per-layer metric then goes with
    every cell that reports the end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (cell in m["workloads"] if "workloads" in m
               else m["moves"] in names)]
    return e2e, per


def cell_from_files(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` as its own files under ``root / tmbench`` state it:
    one chip, no metrics. Tools that run a cell outside a benchmark run
    (the control, the knee sweep) take it from here."""
    spec = load_json(root / PKG / "workloads" / f"{name}.json")
    config = load_json(root / PKG / "configs" / f"{spec['config']}.json")
    return Cell(name=name, chips=1, config=config, kind=spec["kind"],
                params=dict(spec["params"]), end_to_end=[], per_layer=[])


def find_cell(name: str, root: Path = ROOT, bench: dict | None = None) -> Cell:
    """The cell ``name`` from ``BENCHMARK.json`` and its files under
    ``root / tmbench``; raises if any is missing or they disagree."""
    bench = load_json(root / "BENCHMARK.json") if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: "
                       f"{[w['name'] for w in bench['workloads']]}")
    spec = load_json(root / PKG / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if spec[key] != entry[key]:
            raise ValueError(f"{name}: BENCHMARK.json says {key}="
                             f"{entry[key]!r}, the cell's file {spec[key]!r}")
    e2e, per = metrics_for(bench, name)
    return dataclasses.replace(cell_from_files(name, root),
                               chips=int(entry["chips"]), end_to_end=e2e,
                               per_layer=per)


def kind_module(kind: str, root: Path = ROOT):
    """The traffic kind's module ``tmbench/traffic/<kind>.py``."""
    path = root / PKG / "traffic" / f"{kind}.py"
    return load_module(path, f"{PKG}_traffic_{kind}_{_tag(path)}")


def reader(metric: str, root: Path = ROOT):
    """The metric's reader ``tmbench/metrics/<metric>.py``."""
    path = root / PKG / "metrics" / f"{metric}.py"
    return load_module(path, f"{PKG}_metric_{metric.replace('.', '__')}_{_tag(path)}")


def family_of(config: dict) -> str:
    """A configuration's family: its ``family`` key, else ``tm``."""
    return config.get("family", "tm")


def family_module(family: str, root: Path = ROOT):
    """The family's module ``tmbench/families/<family>.py``."""
    path = root / PKG / "families" / f"{family}.py"
    if not path.is_file():
        raise FileNotFoundError(f"configuration family {family!r} has no "
                                f"module: no file {path}")
    return load_module(path, f"{PKG}_family_{family}_{_tag(path)}")


@dataclasses.dataclass
class Context:
    """What a traffic kind gets: the cell, its configuration object (as
    its family builds it), the run's seed, window and trace flag, and the
    device."""

    cell: Cell
    cfg: object
    seed: int
    seconds: float
    trace: bool
    device: object
    started: float            # perf_counter() at process start
    setup_s: float | None = None

    def open_window(self) -> float:
        """Mark set-up done; returns the window's start (perf_counter)."""
        now = time.perf_counter()
        self.setup_s = now - self.started
        return now

    def reset_peak(self) -> None:
        """Start the device memory peak here (the program's own set-up)."""
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak(self) -> int:
        """Device memory peak since :meth:`reset_peak` (0 on the CPU)."""
        import torch
        if self.device.type != "cuda":
            return 0
        torch.cuda.synchronize(self.device)
        return int(torch.cuda.max_memory_allocated(self.device))

    def free(self) -> None:
        """Return freed program memory to the device before the reference."""
        import gc

        import torch
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def build(self) -> None:
        """Build (first run) or load the program's CUDA kernels."""
        if self.device.type == "cuda":
            from repro_torch.kernels import _build
            _build.build_all()

    @staticmethod
    def log(msg: str) -> None:
        """A line on standard error."""
        print(msg, file=sys.stderr, flush=True)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             started: float, root: Path = ROOT) -> dict:
    """Run ``cell`` once; returns the result line's dict (``compared``
    last)."""
    import torch

    family = family_module(family_of(cell.config), root)
    ctx = Context(cell=cell, cfg=family.config(cell.config),
                  seed=seed, seconds=seconds, trace=trace,
                  device=torch.device(device), started=started)
    rec = kind_module(cell.kind, root).run(ctx)
    rec["setup_s"] = ctx.setup_s
    compared = {k: {"value": v, "limit": lim}
                for k, (v, lim) in rec["compared"].items()}
    correct = all(c["value"] <= c["limit"] for c in compared.values())
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"], root).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = ctx.device
    line = {"correct": bool(correct), "attempted": int(rec["attempted"]),
            "failed": int(rec["failed"]), "metrics": metrics,
            "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                       "kind": (torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else "cpu"),
                       "count": cell.chips,
                       "memory_peak_bytes": int(rec["memory_peak_bytes"])}}
    summary = rec.get("trace")
    if trace and summary:
        line["device"]["busy_s"] = summary["busy_s"]
        line["device"]["window_s"] = summary["window_s"]
        line["breakdown"] = {"device_ops": summary["device_ops"],
                             "idle_gaps": summary["idle_gaps"]}
    line["compared"] = compared
    return line


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the run must not load."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    """``name, power.limit`` of the cards as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return "; ".join(out.stdout.strip().splitlines())
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not readable ({e.__class__.__name__})"


def main(argv=None, started: float | None = None) -> int:
    """``--workload <cell> --seed <n> --seconds <s> --trace <0|1>``: run
    the cell once on the cards and print the result as the last line."""
    import argparse

    parser = argparse.ArgumentParser(prog="python -m tmbench.run")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if started is None:
        started = time.perf_counter()
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"tmbench: the program is missing: no {ROOT / 'src' / 'repro_torch'}",
              file=sys.stderr)
        return 2
    if str(ROOT / "src") not in sys.path:
        sys.path.insert(0, str(ROOT / "src"))
    cell = find_cell(args.workload)
    # caches of anything that compiles, fixed inside the checkout (the
    # program's own kernels build into its fixed ``build/``)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"tmbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"this process sees {have}", file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    torch.backends.cuda.matmul.allow_tf32 = False
    Context.log(f"card: {card_line()}")
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                    torch.device("cuda"), started)
    bad = forbidden_modules()
    if bad:
        print(f"tmbench: the run loaded {bad}; the program under test must "
              "not use JAX or the JAX package", file=sys.stderr)
        return 4
    for name, c in line["compared"].items():
        Context.log(f"compared {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(line), flush=True)
    return 0
