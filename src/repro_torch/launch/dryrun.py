"""Dry-run of every cell on the production mesh (the port's
``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
        --shape decode_32k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --tm --async-votes

``lower_cell`` builds ``steps.make_step`` on a trace mesh (16 × 16, or
2 × 16 × 16 with the ``pod`` axis), places the step's ``arg_structs`` by
its ``in_specs`` as fake tensors and runs it once under ``launch.trace``:
whether the step fits (argument, output, temp and alias bytes per device;
peak = argument + output + temp − alias, alias being what the step updates
in place: decode's caches and train's state, which the reference donates),
what it costs (FLOPs and unfused bytes per device) and which collectives
it issues. Records go to ``results/torch/dryrun/<arch>/<shape>/<mesh>.<tag>
.json`` with the reference's keys (``_trace`` for its ``_hlo`` cost
suffix; ``times.trace_s`` for lower and compile), beside a trimmed
collective schedule.

``run_tm_checks`` / ``run_tm_async_checks`` build the sharded TM on a
*real* mesh (CPU, or k ranks on ``cuda:0``): the TM kernels are ctypes
CUDA and cannot run on fake tensors. They hold the port's form of the
reference's contracts: one reduction per sharded scores call, int32
partials only, the composition rule, each kernel-backed engine launching
its kernel on a CUDA mesh and none on a CPU mesh (the reference looks for
``pallas_call`` in the jaxpr), and the asynchronous step's reductions.

``--device cpu`` traces the CPU's program (a torch built without CUDA
cannot trace fake CUDA tensors) and runs the TM checks on the CPU.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import (
    ARCHS, SKIPPED_CELLS, get_config, get_shape, shapes_for)
from repro_torch.launch import trace
from repro_torch.launch.mesh import (
    DeviceMesh, make_mesh, make_production_mesh, make_trace_mesh)
from repro_torch.steps import make_step

RESULTS = Path(__file__).resolve().parents[3] / "results" / "torch" / "dryrun"

# The TM kernel each kernel-backed engine's sharded scores launch per rank.
ENGINE_KERNELS = {"bitpack": "clause_votes_packed", "indexed": "indexed_votes"}


def mesh_name(mesh: DeviceMesh) -> str:
    """``"16x16"``, ``"2x16x16"``, …"""
    return "x".join(str(s) for s in mesh.shape)


def trace_mesh(mesh=None, *, multi_pod: bool = False,
               device="cuda") -> DeviceMesh:
    """A trace mesh: ``mesh`` itself, a shape tuple's mesh, or the
    production mesh; made under a ``FakeTensorMode`` on ``device``."""
    if isinstance(mesh, DeviceMesh):
        return mesh
    with trace.fake_mode(device):
        if mesh is None:
            return make_production_mesh(multi_pod=multi_pod, device=device)
        return make_trace_mesh(*mesh, device=device)


def cell_config(arch: str, cfg_override=None):
    """``arch``'s published config, with ``cfg_override``'s fields."""
    cfg = get_config(arch)
    return dataclasses.replace(cfg, **cfg_override) if cfg_override else cfg


def cell_shape(shape_name: str, shape_override=None):
    """The named shape, with ``shape_override``'s fields (tests cut the
    batch and sequence)."""
    shape = get_shape(shape_name)
    return (dataclasses.replace(shape, **shape_override) if shape_override
            else shape)


def serve_positions(cfg, shape):
    """Whisper's decoder positions of a serving step (``steps``' rule)."""
    if cfg.family == "encdec" and shape.kind != "train":
        return max(shape.seq_len, 4096)
    return None


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               step_kwargs=None, cfg_override=None, save: bool = True,
               tag: str = "baseline", mesh=None, device="cuda",
               shape_override=None) -> dict:
    """Trace one (arch × shape × mesh) cell; returns the record (see the
    module docstring). ``mesh``: a trace ``DeviceMesh`` or a shape tuple
    (tests use small ones); the production mesh by default. ``device``:
    the fake tensors' device when the mesh is made here."""
    cfg = cell_config(arch, cfg_override)
    shape = cell_shape(shape_name, shape_override)
    mesh = trace_mesh(mesh, multi_pod=multi_pod, device=device)
    t0 = time.perf_counter()
    step = make_step(cfg, shape, mesh, **(step_kwargs or {}))
    build_s = time.perf_counter() - t0
    acct = trace.trace_step(step, cfg, mesh,
                            max_positions=serve_positions(cfg, shape))
    coll = acct["collectives"]
    record = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name(mesh),
        "devices": mesh.size, "tag": tag, "trace_device": acct["device"],
        "memory": acct["memory"], "cost": acct["cost"],
        "collectives": {k: coll[k] for k in ("total_bytes", "by_kind", "count",
                                              "by_call", "counter")},
        "loop_dims": step.loop_dims, "meta": step.meta,
        "times": {"build_s": round(build_s, 2),
                  "trace_s": round(acct["trace_s"], 2)},
        "ops": acct["ops"], "cross_rank_ops": acct["cross_rank_ops"],
    }
    if save:
        out = RESULTS / arch / shape_name
        out.mkdir(parents=True, exist_ok=True)
        (out / f"{record['mesh']}.{tag}.json").write_text(
            json.dumps(record, indent=2))
        (out / f"{record['mesh']}.{tag}.schedule.txt").write_text(
            "\n".join(f"{k} {b} {axes}" for k, b, axes in acct["schedule"][:400]))
    return record


# ---------------------------------------------------------------------------
# The sharded TM's contracts, on a real mesh
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def reduction_dtypes():
    """Collect the dtype of every partial that ``core.distributed``'s
    reductions sum while the context is open."""
    from repro_torch.core import distributed

    seen: list = []
    reduce = distributed._reduce

    def spy(groups):
        seen.extend(str(t.dtype).removeprefix("torch.") for g in groups
                    for t in g)
        return reduce(groups)

    distributed._reduce = spy
    try:
        yield seen
    finally:
        distributed._reduce = reduce


def _kernel_counters():
    from repro_torch.kernels import clause_eval, indexed, ta_update

    return (indexed.indexed_votes, clause_eval.clause_votes_packed,
            clause_eval.clause_outputs_packed, clause_eval.round_vote,
            ta_update.ta_update)


@contextlib.contextmanager
def kernel_launches():
    """The five TM kernels' launches while the context is open (each
    wrapper's count, restored after)."""
    counters = _kernel_counters()
    before = {k.__name__: k.launches for k in counters}
    got: dict = {}
    try:
        yield got
    finally:
        got.update({k.__name__: k.launches - before[k.__name__]
                    for k in counters})


def _tm_case(n_clauses: int, data: int, model: int, device):
    from repro_torch.core.types import TMConfig

    cfg = TMConfig(n_classes=10, n_clauses=n_clauses, n_features=196)
    k = data * model
    return cfg, make_mesh(data, model, devices=[device] * k)


def _train_inputs(cfg, mesh, batch: int, seed: int = 0):
    dev = mesh.devices[0]
    xs = torch.zeros((batch, cfg.n_features), dtype=torch.uint8, device=dev)
    ys = torch.zeros((batch,), dtype=torch.int32, device=dev)
    mask = torch.ones((batch,), dtype=torch.bool, device=dev)
    return xs, ys, torch.Generator(device=dev).manual_seed(seed), mask


def run_tm_checks(*, data: int = 2, model: int = 4, n_clauses: int = 256,
                  batch: int = 16, train_batch: int = 8, save: bool = True,
                  expect_composition: str | None = None,
                  device="cuda") -> dict:
    """Run the clause-sharded TM on a ``data × model`` mesh of ``device``
    (k ranks on one device) and hold its contracts (the reference's
    record keys; failures listed, not raised):

      * every registered engine's sharded scores make exactly one
        reduction per call (``.reductions``), of int32 partials;
      * on a CUDA mesh each kernel-backed engine launches its kernel once
        per rank, and no other kernel; on a CPU mesh nothing launches
        (``backend_routes``, the port's form of the reference's
        ``pallas_call`` check);
      * the sequential and batch-parallel train steps reduce only int32
        partials (the reference: all-reduce only), and the learning
        kernels run on a CUDA mesh only;
      * ``expect_composition`` names the rule the sequential step must
        fire (``composed_even``, ``composed_ragged``)."""
    from repro_torch.core import distributed as dist
    from repro_torch.core.engines import registered_engines
    from repro_torch.core.types import init_tm

    cfg, mesh = _tm_case(n_clauses, data, model, device)
    on_card = mesh.devices[0].type == "cuda"
    geom = dist.geometry(cfg, mesh)
    bundle = dist.make_sharded_prepare(cfg, mesh)(init_tm(cfg, mesh.devices[0]))
    xs = torch.zeros((batch, cfg.n_features), dtype=torch.uint8,
                     device=mesh.devices[0])
    record: dict = {"mesh": f"{data}x{model}", "n_clauses": n_clauses,
                    "device": str(mesh.devices[0]),
                    "geometry": {"n_local": geom.n_local,
                                 "n_padded": geom.n_padded,
                                 "n_sub": geom.n_sub,
                                 "ragged_clauses": geom.ragged_clauses},
                    "engines": {}, "backend_routes": {}, "failures": []}
    fails = record["failures"]

    for name in registered_engines():
        s = dist.make_sharded_scores(cfg, mesh, engine=name)
        with reduction_dtypes() as dtypes, kernel_launches() as launched:
            s(bundle, xs)
        ok = s.reductions == 1 and set(dtypes) == {"int32"}
        record["engines"][name] = {
            "collective_count": s.reductions, "partial_dtypes": sorted(set(dtypes)),
            "one_vote_reduction": ok, "kernel_launches": launched}
        print(f"[tm] scores/{name}: reductions={s.reductions} of "
              f"{sorted(set(dtypes))} kernels={launched} "
              f"{'OK' if ok else 'FAIL'}", flush=True)
        if not ok:
            fails.append(f"scores/{name}: expected exactly one reduction of "
                         f"int32 partials, got {s.reductions} of "
                         f"{sorted(set(dtypes))}")
        want = {k: 0 for k in launched}
        kernel = ENGINE_KERNELS.get(name)
        if on_card and kernel is not None:
            want[kernel] = mesh.size
        routed = launched == want
        if kernel is not None:
            record["backend_routes"][name] = {
                "device": str(mesh.devices[0]), "kernel": kernel,
                "launches": launched[kernel], "kernel_routed": launched[kernel] > 0,
                "collective_count": s.reductions, "one_vote_reduction": ok}
        if not routed:
            fails.append(f"scores/{name} on {mesh.devices[0]}: kernel launches "
                         f"{launched}, expected {want}")

    with kernel_launches() as launched:
        for parallel in (False, True):
            step = dist.make_sharded_train_step(cfg, mesh, parallel=parallel,
                                                max_events=1024)
            with reduction_dtypes() as dtypes:
                step(bundle, *_train_inputs(cfg, mesh, train_batch))
            ok = set(dtypes) <= {"int32"}
            key = f"train_step_{'parallel' if parallel else 'sequential'}"
            composition = "batch_parallel" if parallel else geom.composition
            record[key] = {"collective_count": step.reductions,
                           "partial_dtypes": sorted(set(dtypes)),
                           "int32_only": ok, "composition": composition}
            print(f"[tm] {key}: reductions={step.reductions} of "
                  f"{sorted(set(dtypes))} composition={composition} "
                  f"{'OK' if ok else 'FAIL'}", flush=True)
            if not ok:
                fails.append(f"{key}: feedback must reduce int32 partials "
                             f"only, found {sorted(set(dtypes))}")
            if (not parallel and expect_composition is not None
                    and composition != expect_composition):
                fails.append(f"{key}: expected composition rule "
                             f"{expect_composition!r}, fired {composition!r}")
    record["train_kernel_launches"] = dict(launched)
    learning = ("round_vote", "ta_update")
    if on_card != all(launched[k] > 0 for k in learning) or (
            not on_card and any(launched.values())) or (
            launched["clause_outputs_packed"] > 0):
        fails.append(f"train steps on {mesh.devices[0]}: kernel launches "
                     f"{launched}")

    if save:
        out = RESULTS / "tm"
        out.mkdir(parents=True, exist_ok=True)
        (out / f"{record['mesh']}.json").write_text(json.dumps(record, indent=2))
    return record


def run_tm_async_checks(*, k: int = 4, n_clauses: int = 256,
                        train_batch: int = 8, save: bool = True,
                        device="cuda") -> dict:
    """Run the asynchronous (stale-vote) train path on the reference's
    three cells and hold its reductions: the step keeps 0 (clause-only),
    1 (the reassembly under composition) and 1 (the delta sum of batch-
    parallel learning); the refresh makes exactly one; and synchronous
    minus asynchronous is ``2·valid + 1`` per step, the two rounds' vote
    reductions of each valid sample and the overflow sum. (The reference
    counts collectives in a compiled program, where sync − async = 3;
    here every round's reduction runs and is counted.)"""
    from repro_torch.core import distributed as dist
    from repro_torch.core.types import init_tm

    record: dict = {"k": k, "n_clauses": n_clauses, "device": str(device),
                    "cells": {}, "failures": []}
    cells = [("1x4", 1, 4, False, 0), ("2x4", 2, 4, False, 1),
             ("2x4", 2, 4, True, 1)]
    for name, data, model, parallel, allowed in cells:
        cfg, mesh = _tm_case(n_clauses, data, model, device)
        bundle = dist.make_sharded_prepare(cfg, mesh, async_votes=k)(
            init_tm(cfg, mesh.devices[0]))
        inputs = _train_inputs(cfg, mesh, train_batch)
        valid = int(inputs[3].sum())
        mode = "parallel" if parallel else "sequential"
        key = f"{name}/{mode}"
        counts = {}
        for tag, async_votes in (("sync", 0), ("async", k)):
            step = dist.make_sharded_train_step(
                cfg, mesh, parallel=parallel, max_events=1024,
                async_votes=async_votes)
            with reduction_dtypes() as dtypes:
                step(bundle, *_train_inputs(cfg, mesh, train_batch))
            counts[tag] = (step.reductions, sorted(set(dtypes)))
        refresh = dist.make_vote_refresh(cfg, mesh, parallel=parallel)
        with reduction_dtypes() as rdtypes:
            refresh(bundle)
        (s, sd), (a, ad) = counts["sync"], counts["async"]
        ok_step = a == allowed and set(ad) <= {"int32"}
        ok_delta = s - a == 2 * valid + 1
        ok_refresh = refresh.reductions == 1 and set(rdtypes) == {"int32"}
        record["cells"][key] = {
            "composition": ("batch_parallel" if parallel
                            else dist.geometry(cfg, mesh).composition),
            "sync_count": s, "async_count": a, "async_allowed": allowed,
            "valid_samples": valid, "refresh_count": refresh.reductions,
            "partial_dtypes": sorted(set(sd) | set(ad) | set(rdtypes)),
            "zero_vote_collectives": ok_step,
            "removed_vote_collectives": ok_delta,
            "one_refresh_reduction": ok_refresh}
        print(f"[tm-async] {key}: sync={s} async={a} (allowed {allowed}) "
              f"refresh={refresh.reductions} "
              f"{'OK' if ok_step and ok_delta and ok_refresh else 'FAIL'}",
              flush=True)
        if not ok_step:
            record["failures"].append(
                f"{key}: async step must keep {allowed} int32 reduction(s), "
                f"got {a} of {ad}")
        if not ok_delta:
            record["failures"].append(
                f"{key}: async must remove the two vote reductions of each "
                f"of {valid} valid samples and the overflow sum (sync {s} -> "
                f"async {a}, expected {s - 2 * valid - 1})")
        if not ok_refresh:
            record["failures"].append(
                f"{key}: refresh must be exactly one int32 reduction, got "
                f"{refresh.reductions} of {sorted(set(rdtypes))}")
    if save:
        out = RESULTS / "tm"
        out.mkdir(parents=True, exist_ok=True)
        (out / "async.json").write_text(json.dumps(record, indent=2))
    return record


def run_tm(async_votes: bool = False, device="cuda") -> list[dict]:
    """The reference's ``--tm`` cells: the even (2, 4) / 256 cell and the
    ragged (2, 3) / 128 cell, then the asynchronous checks."""
    records = [
        run_tm_checks(expect_composition="composed_even", device=device),
        run_tm_checks(data=2, model=3, n_clauses=128,
                      expect_composition="composed_ragged", device=device),
    ]
    if async_votes:
        records.append(run_tm_async_checks(device=device))
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-pod dry-run (fake tensors)")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tm", action="store_true",
                    help="clause-sharded TM checks on a real mesh (every "
                         "engine; one int32 reduction per scores call)")
    ap.add_argument("--async-votes", action="store_true",
                    help="with --tm: also check the async stale-vote train "
                         "path (no vote reduction in the step, one per "
                         "refresh)")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device, and the TM mesh's "
                         "(cpu on a host without CUDA)")
    args = ap.parse_args(argv)

    if args.tm:
        records = run_tm(args.async_votes, args.device)
        failures = [f for r in records for f in r["failures"]]
        if failures:
            print(f"\n{len(failures)} TM FAILURES:")
            for f in failures:
                print("  ", f)
            raise SystemExit(1)
        print("\nTM sharded checks: all engines OK (one int32 reduction per "
              "scores call; int32-only feedback; composition rules: "
              + ", ".join(f"{r['mesh']}→"
                          f"{r['train_step_sequential']['composition']}"
                          for r in records if "train_step_sequential" in r)
              + ("; async stale-vote route OK" if args.async_votes else "")
              + ")")
        return

    cells = []
    archs = ARCHS if (args.all or not args.arch) else (args.arch,)
    for arch in archs:
        for shape in shapes_for(get_config(arch)):
            if args.shape and shape.name != args.shape:
                continue
            cells.append((arch, shape.name))
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = []
    for arch, shape_name in cells:
        for multi in meshes:
            name = "2x16x16" if multi else "16x16"
            out = RESULTS / arch / shape_name / f"{name}.baseline.json"
            if out.exists():
                print(f"[skip-cached] {arch} × {shape_name} × {name}")
                continue
            print(f"[dryrun] {arch} × {shape_name} × {name} ...", flush=True)
            try:
                rec = lower_cell(arch, shape_name, multi_pod=multi,
                                 device=args.device)
                mem = rec["memory"]["peak_estimate_per_device"] / 2**30
                print(f"  ok: peak≈{mem:.2f} GiB/dev, "
                      f"flops={rec['cost']['flops_per_device_trace']:.3g}, "
                      f"coll={rec['collectives']['total_bytes']:.3g}B, "
                      f"trace={rec['times']['trace_s']}s", flush=True)
            except Exception as e:  # noqa: BLE001 — report and continue
                failures.append((arch, shape_name, name, repr(e)))
                print(f"  FAIL: {e}\n{traceback.format_exc()}", flush=True)
    print("\nskipped cells (per DESIGN.md §5):")
    for (a, s), why in SKIPPED_CELLS.items():
        print(f"  {a} × {s}: {why}")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nall requested cells traced OK")


if __name__ == "__main__":
    main()
