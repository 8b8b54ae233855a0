"""The benchmark's files and dispatch on the CPU: every cell, configuration,
traffic kind and metric is found by name; ``BENCHMARK.json`` keeps the
benchmark contract; a cell added as files only runs, of the TM family or
of another, which brings its control and faults as files too; the TM
configurations and the tests' cuts are the ones the benchmark has run;
the result line has the contract's keys; nothing under
``tmbench/`` imports JAX or the JAX package, and the reference imports
nothing of the program."""
import ast
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from tmbench import control, harness, testing
from tmbench import trace as trace_mod

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
# cells whose files are kept but which BENCHMARK.json does not list
UNLISTED = sorted({p.stem for p in (ROOT / "tmbench" / "workloads").glob("*.json")}
                  - set(CELLS))
# what listing mnist_serve again takes: BENCHMARK.json entries only
SERVE_E2E = [
    {"name": "serve_p50_ms", "unit": "ms", "better": "lower", "bound": 0.25,
     "source": "host_clock", "workloads": ["mnist_serve"]},
    {"name": "serve_p95_ms", "unit": "ms", "better": "lower", "bound": 0.25,
     "source": "host_clock", "workloads": ["mnist_serve"]}]
SERVE_LAYER = [
    {"name": f"serve.{n}", "unit": u, "better": b, "source": src, "layer": lay,
     "moves": "serve_p95_ms", "workloads": ["mnist_serve"]}
    for n, u, b, src, lay in (
        ("batch_rows", "rows", "higher", "program_counter", "server"),
        ("pad_share", "%", "lower", "program_counter", "bucket cache"),
        ("device_idle", "%", "lower", "device_trace", "device"))]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_load_and_are_found_by_name(name):
    cell = harness.find_cell(name)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    spec = json.loads((ROOT / "tmbench" / "workloads" / f"{name}.json").read_text())
    assert spec["why"] == entry["why"]
    assert harness.kind_module(cell.kind).run
    for m in cell.end_to_end + cell.per_layer:
        assert harness.reader(m["name"]).read
    harness.family_module(harness.family_of(cell.config)).config(cell.config)
    assert "setup_s" in {m["name"] for m in cell.end_to_end}
    assert len(cell.end_to_end) >= 2 and cell.per_layer


def check_config(entry: dict, bench: dict, root: Path = ROOT) -> None:
    """The contract of every configuration in ``BENCHMARK.json``
    (``entry``), whatever its family, then its family's own ``check``:
    the file's name, source and ``reduced`` are the entry's, a workload
    uses it, and every key it cut is a key of the file whose published
    value its ``published`` object gives. Raises ValueError."""
    conf = harness.load_json(root / entry["file"])
    name = entry["name"]
    for key in ("name", "source", "reduced"):
        if conf.get(key) != entry[key]:
            raise ValueError(f"{name}: the file's {key} is {conf.get(key)!r}, "
                             f"BENCHMARK.json's {entry[key]!r}")
    if not any(w["config"] == name for w in bench["workloads"]):
        raise ValueError(f"{name}: no workload uses this configuration")
    published = conf.get("published", {})
    for key in entry["reduced"]:
        if key not in conf:
            raise ValueError(f"{name}: reduced names {key!r}, which the "
                             "file does not state")
        if key not in published:
            raise ValueError(f"{name}: reduced names {key!r}, but the "
                             "file's published object gives no value for it")
    harness.family_module(harness.family_of(conf), root).check(conf, entry)


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_state_their_source(conf):
    check_config(conf, BENCH)


def _tm_mnist_entry():
    return dict(next(c for c in BENCH["configs"] if c["name"] == "tm_mnist"))


@pytest.mark.parametrize("change, match", [
    ({"reduced": ["n_clauses"]}, "published"),
    ({"reduced": ["n_clauses"], "published": {"n_states": 127}}, "published"),
    ({"reduced": ["n_layers"], "published": {"n_layers": 4}}, "does not state"),
    ({"reduced": ["n_clauses"], "published": {"n_clauses": 2000}}, "reduced is"),
    ({"source": "https://example.org/elsewhere"}, "source"),
    ({"state_dtype": "int8"}, "int16"),
], ids=["no_published", "published_lacks_the_key", "key_not_in_file",
        "tm_cut", "source", "tm_state_dtype"])
def test_a_config_that_breaks_the_contract_is_refused(tmp_path, change, match):
    conf = json.loads((ROOT / "tmbench/configs/tm_mnist.json").read_text())
    conf.update(change)
    entry = _tm_mnist_entry()
    entry.update({k: v for k, v in change.items() if k == "reduced"},
                 file="tmbench/configs/tm_mnist.json")
    (tmp_path / "tmbench/configs").mkdir(parents=True)
    (tmp_path / entry["file"]).write_text(json.dumps(conf))
    shutil.copytree(ROOT / "tmbench/families", tmp_path / "tmbench/families",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with pytest.raises(ValueError, match=match):
        check_config(entry, BENCH, root=tmp_path)


def test_a_config_of_an_unknown_family_names_the_missing_module(tmp_path):
    conf = {**harness.load_json(ROOT / "tmbench/configs/tm_mnist.json"),
            "family": "no_such_family"}
    path = ROOT / "tmbench" / "families" / "no_such_family.py"
    with pytest.raises(FileNotFoundError, match=re.escape(str(path))):
        harness.family_module(harness.family_of(conf))
    cell = dataclasses.replace(harness.cell_from_files("imdb_score"), config=conf)
    with pytest.raises(FileNotFoundError, match=re.escape(str(path))):
        harness.run_cell(cell, 1, 0.1, False, torch.device("cpu"),
                         time.perf_counter())


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["tmbench"]
    assert len(BENCH["command"]) <= 32
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len({w["name"] for w in BENCH["workloads"]}) == len(CELLS)
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(CELLS)
    assert all(w["chips"] == 1 and len(w["why"]) <= 200 for w in BENCH["workloads"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["source"] in ("device_trace", "host_clock")
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("name", CELLS + UNLISTED)
def test_cell_runs_on_the_cpu_and_prints_the_contract_keys(name, trace):
    cell = testing.tiny(harness.find_cell(name) if name in CELLS
                        else harness.cell_from_files(name))
    line = harness.run_cell(cell, 2**31 + 11, 0.3, trace, torch.device("cpu"),
                            time.perf_counter())
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "compared"
    assert line["correct"] is True and line["attempted"] > 0
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    want = cell.per_layer if trace else cell.end_to_end
    assert set(line["metrics"]) <= {m["name"] for m in want}
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert len(line["breakdown"]["device_ops"]) <= 10
        assert len(line["breakdown"]["idle_gaps"]) <= 10
    else:
        assert set(line["metrics"]) == {m["name"] for m in want}
        assert all(math.isfinite(v["value"]) for v in line["metrics"].values())
    for c in line["compared"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(line)


def _root_with(tmp_path, edit):
    """A copy of the benchmark under ``tmp_path`` with ``edit(bench)``
    applied to its ``BENCHMARK.json``."""
    shutil.copytree(ROOT / "tmbench", tmp_path / "tmbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    edit(bench)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def test_a_cell_added_as_files_only_runs(tmp_path):
    conf = json.loads((ROOT / "tmbench/configs/tm_mnist.json").read_text())
    conf.update(harness.family_module("tm").TINY, name="tm_small")
    spec = {"config": "tm_small", "traffic": "test_set_b32", "kind": "offline_score",
            "params": {"pool_rows": 100, "base": "data", "batch": 32,
                       "trace_batches": 2},
            "why": "a throwaway cell"}

    def edit(bench):
        bench["configs"].append({"name": "tm_small", "source": conf["source"],
                                 "file": "tmbench/configs/tm_small.json",
                                 "reduced": [], "why": "a throwaway config"})
        bench["workloads"].append({"name": "small_score", "config": "tm_small",
                                   "traffic": "test_set_b32", "chips": 1,
                                   "why": "a throwaway cell"})
        next(m for m in bench["end_to_end"]
             if m["name"] == "score_rows_per_s")["workloads"].append("small_score")

    root = _root_with(tmp_path, edit)
    (root / "tmbench/configs/tm_small.json").write_text(json.dumps(conf))
    (root / "tmbench/workloads/small_score.json").write_text(json.dumps(spec))
    cell = harness.find_cell("small_score", root=root)
    assert cell.kind == "offline_score" and cell.config["n_clauses"] == 32
    line = harness.run_cell(cell, 5, 0.2, False, torch.device("cpu"),
                            time.perf_counter(), root=root)
    assert line["correct"] is True
    assert set(line["metrics"]) == {"score_rows_per_s", "setup_s"}


# A family that is no Tsetlin Machine, added as files only: one linear
# layer learned by SGD from the seed, judged against a plain recomputation.
TOY_FILES = {
    "tmbench/families/toy.py": '''
"""One linear layer, learned by SGD."""
import contextlib
import types

import torch

TINY = {"n_in": 8}


def config(conf):
    return types.SimpleNamespace(n_in=conf["n_in"], n_out=conf["n_out"],
                                 lr=conf["lr"], dtype=conf["dtype"])


def check(conf, entry):
    if conf["n_out"] < 1 or conf["lr"] <= 0:
        raise ValueError(f"{conf['name']}: a layer with no output or no step")


@contextlib.contextmanager
def mode(kind, which):
    """control: the forward pass in float32 for float64; unchanged: a step
    that leaves the layer as it was; altered: one weight off by one."""
    forward, step = torch.nn.Linear.forward, torch.optim.SGD.step
    if which == "control":
        def low(self, x):
            return torch.nn.functional.linear(
                x.float(), self.weight.float(), self.bias.float()).to(x.dtype)
        torch.nn.Linear.forward = low
    elif which == "unchanged":
        torch.optim.SGD.step = lambda self, closure=None: None
    elif which == "altered":
        def altered(self, closure=None):
            step(self, closure)
            with torch.no_grad():
                self.param_groups[0]["params"][0][0, 0] += 1
        torch.optim.SGD.step = altered
    try:
        yield
    finally:
        torch.nn.Linear.forward, torch.optim.SGD.step = forward, step
''',
    "tmbench/traffic/toy_sgd.py": '''
"""SGD steps of an ``nn.Linear`` on rows from the seed for the window,
then the same steps recomputed by hand from the same start."""
import time

import torch

from tmbench.trace import Slice

FAULTS = ("unchanged", "altered")
TINY_PARAMS = {"batch": 4}


def run(ctx):
    cfg, p, dev = ctx.cfg, ctx.cell.params, ctx.device
    dtype = getattr(torch, cfg.dtype)
    g = torch.Generator().manual_seed(ctx.seed)
    x = torch.randn(p["pool_rows"], cfg.n_in, generator=g, dtype=dtype)
    y = torch.randn(p["pool_rows"], cfg.n_out, generator=g, dtype=dtype)
    lin = torch.nn.Linear(cfg.n_in, cfg.n_out, dtype=dtype).to(dev)
    with torch.no_grad():
        lin.weight.copy_(torch.randn(cfg.n_out, cfg.n_in, generator=g,
                                     dtype=dtype))
        lin.bias.zero_()
    w, b0 = lin.weight.detach().cpu().clone(), lin.bias.detach().cpu().clone()
    opt = torch.optim.SGD(lin.parameters(), lr=cfg.lr)
    b, n = p["batch"], p["pool_rows"] // p["batch"]
    x_dev, y_dev = x.to(dev), y.to(dev)

    def step(s):
        a = (s % n) * b
        opt.zero_grad()
        ((lin(x_dev[a:a + b]) - y_dev[a:a + b]) ** 2).mean().backward()
        opt.step()

    step(0)
    steps = 1
    t0 = ctx.open_window()
    while time.perf_counter() - t0 < ctx.seconds:
        step(steps)
        steps += 1
    window_s = time.perf_counter() - t0
    samples = (steps - 1) * b
    trace = None
    if ctx.trace:
        with Slice(dev) as sl:
            for _ in range(2):
                step(steps)
                steps += 1
        trace = sl.summary()
    peak = ctx.peak()
    for s in range(steps):
        a = (s % n) * b
        xb, yb = x[a:a + b], y[a:a + b]
        r = 2 * (xb @ w.T + b0 - yb) / yb.numel()
        w -= cfg.lr * r.T @ xb
        b0 -= cfg.lr * r.sum(0)
    gap = max(float((lin.weight.detach().cpu() - w).abs().max()),
              float((lin.bias.detach().cpu() - b0).abs().max()))
    return {"attempted": samples, "failed": 0,
            "compared": {"param_gap": (gap, 1e-9)},
            "memory_peak_bytes": peak,
            "data": {"samples": samples, "window_s": window_s,
                     "step_ms": 1e3 * window_s / max(steps - 1, 1)},
            "trace": trace}
''',
    "tmbench/metrics/toy.step_ms.py": '''
def read(run):
    return run["data"]["step_ms"]
''',
    "tmbench/configs/toy_linear.json": json.dumps({
        "name": "toy_linear", "family": "toy",
        "source": "https://pytorch.org/docs/stable/generated/torch.nn.Linear.html",
        "n_in": 64, "n_out": 4, "n_layers": 1, "lr": 0.01, "dtype": "float64",
        "reduced": ["n_layers"], "published": {"n_layers": 3}}),
    "tmbench/workloads/toy_train.json": json.dumps({
        "config": "toy_linear", "traffic": "sgd_b16", "kind": "toy_sgd",
        "params": {"pool_rows": 256, "batch": 16},
        "why": "a throwaway cell of another family"}),
}
TM_KEYS = ("n_classes", "n_clauses", "n_features", "n_states", "s",
           "threshold", "boost_true_positive", "empty_clause_output",
           "state_dtype")


def _toy_root(tmp_path, family=None):
    """A copy of the benchmark with the toy family's files and entries
    added (its family module's text replaced by ``family``)."""
    root = _root_with(tmp_path, _add_toy)
    for rel, text in TOY_FILES.items():
        assert not (root / rel).exists()
        if family is not None and rel == "tmbench/families/toy.py":
            text = family
        (root / rel).write_text(text)
    return root


def _add_toy(bench):
    conf = json.loads(TOY_FILES["tmbench/configs/toy_linear.json"])
    bench["configs"].append({"name": "toy_linear", "source": conf["source"],
                             "file": "tmbench/configs/toy_linear.json",
                             "reduced": ["n_layers"],
                             "why": "a throwaway config of another family"})
    bench["workloads"].append({"name": "toy_train", "config": "toy_linear",
                               "traffic": "sgd_b16", "chips": 1,
                               "why": "a throwaway cell of another family"})
    next(m for m in bench["end_to_end"]
         if m["name"] == "train_samples_per_s")["workloads"].append("toy_train")
    bench["per_layer"].append({"name": "toy.step_ms", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "whole step",
                               "moves": "train_samples_per_s",
                               "workloads": ["toy_train"]})


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_a_cell_of_another_family_added_as_files_only_runs(tmp_path, trace):
    root = _toy_root(tmp_path)
    bench = harness.load_json(root / "BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == "toy_linear")
    check_config(entry, bench, root)
    cell = harness.find_cell("toy_train", root=root)
    assert harness.family_of(cell.config) == "toy"
    assert not set(cell.config) & set(TM_KEYS) and cell.config["reduced"]
    cell = testing.tiny(cell, root)
    assert cell.config["n_in"] == 8 and cell.params["batch"] == 4
    line = harness.run_cell(cell, 2**31 + 23, 0.2, trace, torch.device("cpu"),
                            time.perf_counter(), root=root)
    assert line["correct"] is True and line["attempted"] > 0
    assert list(line["compared"]) == ["param_gap"]
    want = {"toy.step_ms"} if trace else {"train_samples_per_s", "setup_s"}
    assert set(line["metrics"]) == want
    assert all(v["value"] > 0 for v in line["metrics"].values())
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
    for path in (ROOT / "tmbench").rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            copy = root / path.relative_to(ROOT)
            assert copy.read_bytes() == path.read_bytes(), path


@pytest.mark.parametrize("mode", ["program", "control", "unchanged", "altered"])
def test_a_family_brings_its_control_and_faults_as_files(tmp_path, mode):
    root = _toy_root(tmp_path)
    assert control.faults_for("toy_sgd", root) == ("unchanged", "altered")
    cell = testing.tiny(harness.find_cell("toy_train", root=root), root)
    (_, line), = control.run("toy_train", mode, [2**31 + 41], 0.2,
                             torch.device("cpu"), root, cell=cell)
    assert line["correct"] is (mode == "program"), line["compared"]
    assert torch.nn.Linear.forward.__name__ == "forward"


def test_a_family_without_a_control_is_refused_by_name(tmp_path):
    text = TOY_FILES["tmbench/families/toy.py"]
    root = _toy_root(tmp_path, family=text[:text.index("@contextlib")])
    cell = testing.tiny(harness.find_cell("toy_train", root=root), root)
    with pytest.raises(ValueError, match="family 'toy' has no control"):
        next(control.run("toy_train", "program", [1], 0.1,
                         torch.device("cpu"), root, cell=cell))
    with pytest.raises(SystemExit, match="family 'toy'"):
        control.probe_events(cell, [1], 1, torch.device("cpu"))


# The TMConfig each TM configuration file gave the traffic kinds before the
# configuration families, field for field.
PINNED_TM = {
    "tm_mnist": dict(n_classes=10, n_clauses=2000, n_features=784,
                     n_states=127, s=10.0, threshold=50,
                     boost_true_positive=False, empty_clause_output=1,
                     state_dtype=torch.int16),
    "tm_imdb": dict(n_classes=2, n_clauses=2000, n_features=5000,
                    n_states=127, s=27.0, threshold=40,
                    boost_true_positive=False, empty_clause_output=1,
                    state_dtype=torch.int16),
}


@pytest.mark.parametrize("config", sorted(PINNED_TM))
def test_run_cell_hands_the_kinds_the_pinned_tm_config(config, monkeypatch):
    from repro_torch.core.types import TMConfig

    name = next(w["name"] for w in BENCH["workloads"] if w["config"] == config)
    seen = []

    class Kind:
        @staticmethod
        def run(ctx):
            seen.append(ctx.cfg)
            return {"attempted": 1, "failed": 0, "compared": {}, "data": {},
                    "memory_peak_bytes": 0}

    monkeypatch.setattr(harness, "kind_module", lambda kind, root=ROOT: Kind)
    cell = dataclasses.replace(harness.find_cell(name), end_to_end=[],
                               per_layer=[])
    harness.run_cell(cell, 1, 0.0, False, torch.device("cpu"),
                     time.perf_counter())
    assert seen == [TMConfig(**PINNED_TM[config])]


# What the tests' cut of each cell was before the configuration families:
# the TM family's TINY over the configuration, the kind's parameters over
# the cell's.
TM_TINY = {"n_classes": 3, "n_clauses": 32, "n_features": 16, "threshold": 5,
           "avg_clause_len": 4}
PINNED_TINY_PARAMS = {
    "imdb_score": {"pool_rows": 300, "batch": 64, "trace_batches": 3},
    "imdb_train": {"pool_rows": 200, "batch": 8, "max_events_per_batch": 4096,
                   "tail_steps": 1, "trace_steps": 2},
    "mnist_serve": {"rate_rps": 300, "pool_rows": 64, "warm_seconds": 0.1,
                    "trace_seconds": 0.2},
    "mnist_train": {"pool_rows": 200, "batch": 8, "max_events_per_batch": 4096,
                    "tail_steps": 1, "trace_steps": 2},
}


@pytest.mark.parametrize("name", sorted(PINNED_TINY_PARAMS))
def test_the_tests_cut_of_each_cell_is_pinned(name):
    spec = harness.load_json(ROOT / "tmbench/workloads" / f"{name}.json")
    conf = harness.load_json(ROOT / "tmbench/configs" / f"{spec['config']}.json")
    cell = testing.tiny(harness.cell_from_files(name))
    assert cell.config == {**conf, **TM_TINY}
    assert cell.params == {**spec["params"], **PINNED_TINY_PARAMS[name]}


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_listing_the_serving_cell_takes_benchmark_entries_only(tmp_path, trace):
    def edit(bench):
        spec = json.loads((ROOT / "tmbench/workloads/mnist_serve.json").read_text())
        bench["workloads"].append({"name": "mnist_serve", "config": spec["config"],
                                   "traffic": spec["traffic"], "chips": 1,
                                   "why": spec["why"]})
        bench["end_to_end"] += SERVE_E2E
        bench["per_layer"] += SERVE_LAYER

    root = _root_with(tmp_path, edit)
    cell = testing.tiny(harness.find_cell("mnist_serve", root=root))
    line = harness.run_cell(cell, 9, 0.3, trace, torch.device("cpu"),
                            time.perf_counter(), root=root)
    assert line["correct"] is True
    want = ({"serve.batch_rows", "serve.pad_share"} if trace
            else {"serve_p50_ms", "serve_p95_ms", "setup_s"})
    assert set(line["metrics"]) == want


def test_every_metric_reader_is_listed_or_serves_the_unlisted_cell():
    names = {p.stem for p in (ROOT / "tmbench" / "metrics").glob("*.py")}
    listed = {m["name"] for k in ("end_to_end", "per_layer") for m in BENCH[k]}
    kept = {m["name"] for m in SERVE_E2E + SERVE_LAYER}
    assert names == listed | kept


def _sources():
    return sorted(p for p in (ROOT / "tmbench").rglob("*.py")
                  if "__pycache__" not in p.parts)


def test_nothing_under_tmbench_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not (_imports(path) & FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "tmbench" / "reference").glob("*.py"):
        assert _imports(path) <= {"__future__", "numpy", "torch"}, path


def _run_harness(cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-m", "tmbench.run", "--workload", CELLS[0],
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


def test_without_the_program_the_harness_fails_and_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "tmbench", tmp_path / "tmbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_harness(tmp_path)
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_without_a_card_the_harness_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    out = _run_harness(ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout


def _event(cat, ts, dur, name="k"):
    return {"ph": "X", "cat": cat, "ts": ts, "dur": dur, "name": name}


def test_the_trace_reads_busy_time_as_the_union_of_device_work():
    events = [_event("kernel", 0, 100), _event("gpu_memcpy", 50, 100),
              _event("kernel", 400, 100), _event("cpu_op", 0, 600, "step")]
    got = trace_mod.reduce_events(events, 600e-6)
    assert got["busy_s"] == pytest.approx(250e-6)
    assert got["idle_gaps"] == [["step", pytest.approx(350e-6)]]


def test_the_trace_refuses_more_busy_time_than_its_slice():
    with pytest.raises(ValueError, match="busy"):
        trace_mod.reduce_events([_event("kernel", 0, 700)], 600e-6)
