"""The benchmark's files and dispatch on the CPU: every cell, configuration,
traffic kind and metric is found by name; ``BENCHMARK.json`` keeps the
benchmark contract; a cell added as files only runs; the result line has
the contract's keys; nothing under ``tmbench/`` imports JAX or the JAX
package, and the reference imports nothing of the program."""
import ast
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

from tmbench import harness, testing
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
    harness.tm_config(cell.config)
    assert "setup_s" in {m["name"] for m in cell.end_to_end}
    assert len(cell.end_to_end) >= 2 and cell.per_layer


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_state_their_source(conf):
    data = json.loads((ROOT / conf["file"]).read_text())
    assert data["name"] == conf["name"]
    assert data["source"] == conf["source"]
    assert data["reduced"] == conf["reduced"] == []
    assert data["state_dtype"] == "int16" and data["vote_dtype"] == "int32"
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])


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
    conf.update(testing.TINY, name="tm_small")
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
