"""The port's dry-run and roofline tools (``repro_torch.launch.{trace,
dryrun,roofline,roofline_sweep,report}``) on the CPU.

Steps are traced on fake CPU tensors (a torch built without CUDA cannot
index or differentiate a fake CUDA tensor, and these tests need no card)
at ``reduce_config`` widths on small trace meshes. The reference's numbers come from one
subprocess (8 forced host devices; its (2, 2) mesh takes the first 4)
that compiles each step as ``repro.launch.dryrun.lower_cell`` does.

Every comparison is exact:
  * ``model_flops`` against the reference's for every arch × shape;
  * argument and output bytes per device against the reference's
    ``compiled.memory_analysis()``. XLA's output size also counts the
    output tuple's table of buffer pointers, 8 bytes per leaf, which is
    added explicitly; the reference prunes arguments a program never
    reads, and so does the trace (whisper's weight-stationary decode never
    reads the cross-attention ``wk`` / ``wv``: the cross K/V come from the
    cache);
  * a traced step's FLOPs against ``FlopCounterMode`` over the same step
    run for real on a CPU mesh, its collective calls and payload bytes
    against the real run's counter, the per-device result bytes against
    ``trace.counter_stats`` of that counter, per-rank figures plus the
    unattributed part against the totals;
  * ``probe_costs``' reconstruction against the direct full-depth count;
  * the sharded TM's geometry and composition rule against the
    reference's (which ``run_tm_checks`` records from those functions).
"""
import dataclasses
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch import configs, sharding, steps
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun, report, roofline, trace
from repro_torch.launch.mesh import (
    DeviceMesh, axis_groups, axis_index, axis_size, make_mesh,
    make_production_mesh, make_trace_mesh)

ROOT = Path(__file__).resolve().parents[1]
MEM_ARCHS = ("qwen3-1.7b", "qwen2-moe-a2.7b", "whisper-medium")
# (named shape, its cut, step keywords): the kinds at test size
CELLS = {"decode": ("decode_32k", {"seq_len": 32, "global_batch": 4}, {}),
         "prefill": ("prefill_32k", {"seq_len": 16, "global_batch": 4}, {}),
         "train": ("train_4k", {"seq_len": 16, "global_batch": 8},
                   {"microbatches": 2})}

REFERENCE = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, "src")
    import jax
    from repro.configs import ARCHS, get_config, reduce_config, shapes_for
    from repro.configs.base import ShapeSpec
    from repro.core import TMConfig
    from repro.core.distributed import geometry, make_sharded_train_step
    from repro.launch.mesh import make_host_mesh, mesh_context
    from repro.launch.roofline import model_flops
    from repro.sharding import named_shardings
    from repro.steps import make_step

    cells = json.loads(sys.argv[1])
    out = {"model_flops": {}, "memory": {}, "tm": {}}
    for a in ARCHS:
        cfg = get_config(a)
        for s in shapes_for(cfg):
            out["model_flops"][f"{a}/{s.name}"] = model_flops(cfg, s)
    mesh = make_host_mesh(2, 2)
    for a in %(archs)r:
        cfg = reduce_config(get_config(a))
        for kind, (name, cut, kw) in cells.items():
            step = make_step(cfg, ShapeSpec(name, kind, cut["seq_len"],
                                            cut["global_batch"]), mesh, **kw)
            donate = {"train": (0,), "decode": (1,), "prefill": ()}[kind]
            with mesh_context(mesh):
                jitted = jax.jit(step.fn,
                                 in_shardings=named_shardings(mesh, step.in_specs),
                                 out_shardings=named_shardings(mesh, step.out_specs),
                                 donate_argnums=donate)
                ma = jitted.lower(*step.arg_structs).compile().memory_analysis()
                leaves = len(jax.tree_util.tree_leaves(
                    jax.eval_shape(step.fn, *step.arg_structs)))
            out["memory"][f"{a}/{kind}"] = {
                "argument": ma.argument_size_in_bytes,
                "output": ma.output_size_in_bytes, "output_leaves": leaves}
    for data, model, n in ((2, 4, 256), (2, 3, 128)):
        cfg = TMConfig(n_classes=10, n_clauses=n, n_features=196)
        m = make_host_mesh(data=data, model=model)
        g = geometry(cfg, m)
        out["tm"][f"{data}x{model}"] = {
            "geometry": {"n_local": g.n_local, "n_padded": g.n_padded,
                         "n_sub": g.n_sub, "ragged_clauses": g.ragged_clauses},
            "sequential": make_sharded_train_step(
                cfg, m, parallel=False, max_events=1024).composition,
            "parallel": make_sharded_train_step(
                cfg, m, parallel=True, max_events=1024).composition}
    print(json.dumps(out))
""") % {"archs": MEM_ARCHS}


@pytest.fixture(scope="module")
def reference():
    pytest.importorskip("jax")
    res = subprocess.run([sys.executable, "-c", REFERENCE, json.dumps(CELLS)],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def reduced(arch, **changes) -> dict:
    """``reduce_config``'s fields as a ``cfg_override`` of ``arch``."""
    cfg = dataclasses.replace(configs.reduce_config(configs.get_config(arch)),
                              **changes)
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def traced(arch, kind, mesh=(2, 2), **changes) -> dict:
    name, cut, kw = CELLS[kind]
    return dryrun.lower_cell(arch, name, cfg_override=reduced(arch, **changes),
                             shape_override=cut, step_kwargs=kw, mesh=mesh,
                             device="cpu", save=False)


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------


def test_model_flops_equals_reference(reference):
    got = {f"{a}/{s.name}": roofline.model_flops(configs.get_config(a), s)
           for a in configs.ARCHS for s in configs.shapes_for(configs.get_config(a))}
    assert got == reference["model_flops"]


@pytest.mark.parametrize("kind", tuple(CELLS))
@pytest.mark.parametrize("arch", MEM_ARCHS)
def test_argument_and_output_bytes_equal_reference(reference, arch, kind):
    rec = traced(arch, kind)
    want = reference["memory"][f"{arch}/{kind}"]
    mem = rec["memory"]
    assert mem["argument_bytes_per_device"] == want["argument"]
    assert (mem["output_bytes_per_device"] + 8 * want["output_leaves"]
            == want["output"])
    assert mem["peak_estimate_per_device"] == (
        mem["argument_bytes_per_device"] + mem["output_bytes_per_device"]
        + mem["temp_bytes_per_device"] - mem["alias_bytes_per_device"])


@pytest.mark.parametrize("mesh,n_clauses", [((2, 4), 256), ((2, 3), 128)])
def test_tm_checks_match_reference(reference, mesh, n_clauses):
    data, model = mesh
    rule = "composed_even" if n_clauses == 256 else "composed_ragged"
    rec = dryrun.run_tm_checks(data=data, model=model, n_clauses=n_clauses,
                               expect_composition=rule, device="cpu",
                               save=False)
    want = reference["tm"][f"{data}x{model}"]
    assert rec["failures"] == []
    assert rec["geometry"] == want["geometry"]
    assert rec["train_step_sequential"]["composition"] == want["sequential"] == rule
    assert rec["train_step_parallel"]["composition"] == want["parallel"]
    for name, eng in rec["engines"].items():
        assert eng["collective_count"] == 1 and eng["partial_dtypes"] == ["int32"]
        assert not any(eng["kernel_launches"].values()), name
    assert set(rec["backend_routes"]) == set(dryrun.ENGINE_KERNELS)
    assert not any(rec["train_kernel_launches"].values())


def test_tm_async_checks_hold_on_the_cpu():
    rec = dryrun.run_tm_async_checks(device="cpu", save=False)
    assert rec["failures"] == []
    cells = rec["cells"]
    assert [c["async_count"] for c in cells.values()] == [0, 1, 1]
    for c in cells.values():
        assert c["refresh_count"] == 1
        assert c["sync_count"] - c["async_count"] == 2 * c["valid_samples"] + 1


# ---------------------------------------------------------------------------
# The trace against a real run of the same program
# ---------------------------------------------------------------------------


def real_run(arch, kind, mesh_shape):
    """The step run for real on a CPU mesh from seeded values: FLOPs by
    ``trace.flop_counter()`` and the mesh counter's snapshot."""
    name, cut, kw = CELLS[kind]
    cfg = configs.reduce_config(configs.get_config(arch))
    shape = dryrun.cell_shape(name, cut)
    mesh = make_mesh(*mesh_shape, device="cpu")
    step = steps.make_step(cfg, shape, mesh, **kw)
    args = trace.real_step_args(step, cfg, mesh, "cpu",
                                max_positions=dryrun.serve_positions(cfg, shape))
    mesh.collectives.reset()
    with trace.flop_counter() as fc:
        step.fn(*args)
    return fc.get_total_flops(), mesh.collectives.snapshot(), mesh


@pytest.mark.parametrize("kind", ("decode", "train"))
@pytest.mark.parametrize("arch", MEM_ARCHS)
def test_trace_equals_a_real_cpu_run(arch, kind):
    rec = traced(arch, kind)
    flops, counter, mesh = real_run(arch, kind, (2, 2))
    cost, coll = rec["cost"], rec["collectives"]
    assert cost["flops_all_ranks_trace"] == flops
    assert coll["counter"] == counter
    stats = trace.counter_stats(counter, mesh)
    assert stats.by_kind == coll["by_kind"]
    assert stats.total_bytes == coll["total_bytes"]
    assert stats.count == coll["count"] == sum(counter["calls"].values())
    # the ranks plus the unattributed part are the whole; matrix products
    # always read a rank's tensor, so no FLOP goes unattributed
    assert cost["flops_unattributed_trace"] == 0
    assert cost["flops_per_device_trace"] * mesh.size == flops


def test_unsharded_trace_equals_a_real_cpu_run():
    name, cut, kw = CELLS["train"]
    cfg = configs.reduce_config(configs.get_config("qwen3-1.7b"))
    step = steps.make_step(cfg, dryrun.cell_shape(name, cut), **kw)
    acct = trace.trace_step(step, cfg, device="cpu")
    args = trace.real_step_args(step, cfg, None, "cpu")
    with trace.flop_counter() as fc:
        step.fn(*args)
    assert acct["cost"]["flops_per_device_trace"] == fc.get_total_flops()
    assert acct["collectives"]["count"] == 0
    mem = acct["memory"]
    # the train state is updated in place: every output but the metrics
    # and the new step counter aliases an argument
    assert mem["output_bytes_per_device"] - mem["alias_bytes_per_device"] == 4 * 5


@pytest.mark.parametrize("kind,group,payload,ranks,want", [
    ("psum", 4, 8 * 100, 8, 100), ("pmean", 2, 8 * 100, 8, 100),
    ("all_gather", 4, 8 * 100, 8, 400), ("psum_scatter", 4, 8 * 100, 8, 25),
    ("all_to_all", 4, 8 * 100, 8, 100), ("ppermute", 2, 8 * 100, 8, 100)])
def test_result_bytes_from_a_counter_payload(kind, group, payload, ranks, want):
    assert trace.result_bytes(kind, payload, group, ranks) == want


def test_per_rank_figures_sum_to_the_whole():
    name, cut, kw = CELLS["train"]
    cfg = configs.reduce_config(configs.get_config("qwen3-1.7b"))
    shape = dryrun.cell_shape(name, cut)
    mesh = dryrun.trace_mesh((2, 2), device="cpu")
    acct = trace.trace_step(steps.make_step(cfg, shape, mesh, **kw), cfg, mesh)
    one = trace.trace_step(steps.make_step(cfg, shape, **kw), cfg, device="cpu")
    cost, per = acct["cost"], acct["per_rank"]
    for key, part in (("flops", "flops"), ("bytes_accessed", "bytes")):
        assert (sum(per[part]) + cost[f"{key}_unattributed_trace"]
                == cost[f"{key}_all_ranks_trace"]), key
        assert cost[f"{key}_per_device_trace"] == max(per[part])
    # sharding splits the work: the ranks' FLOPs add up to one device's
    assert cost["flops_all_ranks_trace"] == one["cost"]["flops_per_device_trace"]
    assert per["argument_bytes"] == [acct["memory"]["argument_bytes_per_device"]] * 4
    assert acct["cross_rank_ops"] > 0        # the gradients' cross-rank sums


# ---------------------------------------------------------------------------
# Probes, pods, meshes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ("decode", "train"))
def test_probe_reconstruction_equals_the_direct_count(kind):
    name, cut, kw = CELLS[kind]
    over = reduced("qwen3-1.7b", n_layers=4)
    direct = roofline.per_device(dryrun.lower_cell(
        "qwen3-1.7b", name, cfg_override=over, shape_override=cut,
        step_kwargs=kw, mesh=(2, 2), device="cpu", save=False))
    probed = roofline.probe_costs(
        "qwen3-1.7b", name, cfg_override=over, shape_override=cut,
        mesh=(2, 2), device="cpu", verbose=False,
        microbatches_full=kw.get("microbatches", 8))
    assert probed["per_device"] == direct


def pod_mesh():
    """A (2, 2, 2) mesh of the CPU: pod, data, model."""
    return DeviceMesh(devices=(torch.device("cpu"),) * 8, shape=(2, 2, 2))


def test_pod_axis_decode_matches_the_two_axis_mesh():
    pod = traced("qwen3-1.7b", "decode", mesh=(2, 2, 2))
    flat = traced("qwen3-1.7b", "decode", mesh=(4, 2))
    assert pod["mesh"] == "2x2x2" and pod["devices"] == 8
    # the batch and the caches split the same ways; the weights are not
    # split over ``pod`` (pure data parallelism), only over data's 2 ranks
    for key in ("output_bytes_per_device", "alias_bytes_per_device"):
        assert pod["memory"][key] == flat["memory"][key], key
    assert (pod["memory"]["argument_bytes_per_device"]
            > flat["memory"]["argument_bytes_per_device"])
    assert (pod["cost"]["flops_per_device_trace"]
            == flat["cost"]["flops_per_device_trace"])
    # weight-stationary decode splits d over data alone, so the two meshes
    # move different activations, and the pod mesh fewer bytes, as in the
    # reference's two programs (10,612 bytes per device on (2, 2, 2)
    # against 13,740 on (4, 2), use_scan=False): a rank of the pod mesh
    # sums its pod's rows over data, not the whole batch
    assert (pod["collectives"]["total_bytes"]
            < flat["collectives"]["total_bytes"])
    cfg = configs.reduce_config(configs.get_config("qwen3-1.7b"))
    shape = ShapeSpec("d", "decode", 32, 8)
    meshes = {"pod": pod_mesh(), "flat": make_mesh(4, 2, device="cpu")}
    built = {k: steps.make_decode_step(cfg, shape, m) for k, m in meshes.items()}
    assert steps.batch_axes_for(8, meshes["pod"]) == ("pod", "data")
    assert built["pod"].out_specs[0] == sharding.P(("pod", "data"))
    assert built["flat"].out_specs[0] == sharding.P("data")
    for k, m in meshes.items():
        local = sharding.local_shape((8, cfg.vocab), built[k].out_specs[0], m)
        assert local == (2, cfg.vocab), k


def test_pod_mesh_decode_runs_as_the_two_axis_mesh():
    """A real decode step on a (2, 2, 2) CPU mesh gives the (4, 2) mesh's
    logits: the same rows per rank, the same model-axis sums; the
    weight-stationary partial sums over data group d in two slices
    against four, in float32, below the logits' bf16 rounding."""
    cfg = configs.reduce_config(configs.get_config("qwen3-1.7b"))
    shape = ShapeSpec("d", "decode", 32, 8)
    params = steps.build(cfg).init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (8, 4), generator=torch.Generator()
                         .manual_seed(1), dtype=torch.int32)
    out = {}
    for key, mesh in (("pod", pod_mesh()), ("flat", make_mesh(4, 2, device="cpu"))):
        sp = sharding.shard_module(params, mesh)
        pre = steps.make_prefill_step(cfg, ShapeSpec("p", "prefill", 32, 8), mesh)
        dec = steps.make_decode_step(cfg, shape, mesh)
        with torch.no_grad():
            _, cache = pre.fn(sp, sharding.shard_tree({"tokens": toks},
                                                      pre.in_specs[1], mesh))
            tok = sharding.shard(toks[:, :1], dec.in_specs[2], mesh)
            pos = sharding.shard(torch.full((8,), 4, dtype=torch.int32),
                                 dec.in_specs[3], mesh)
            logits, _ = dec.fn(sp, cache, tok, pos)
        out[key] = sharding.gather(logits, dec.out_specs[0], mesh)
    assert torch.equal(out["pod"], out["flat"])


def test_mesh_axes_with_a_pod():
    mesh = make_trace_mesh(2, 2, 2, device="cpu")
    assert mesh.axis_names == ("pod", "data", "model")
    assert (mesh.data, mesh.model, mesh.size) == (2, 2, 8)
    assert axis_size(mesh, ("pod", "data")) == 4
    assert [axis_index(mesh, r, ("pod", "data")) for r in range(8)] == [
        0, 0, 1, 1, 2, 2, 3, 3]
    assert axis_groups(mesh, "pod") == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert axis_groups(mesh, "model") == [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError):
        mesh.device(0, 0)
    with pytest.raises(ValueError):
        axis_size(make_trace_mesh(2, 2, device="cpu"), "pod")


def test_trace_mesh_raises_outside_fake_mode_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("needs a host without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_trace_mesh(2, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_production_mesh()
    with trace.fake_mode("cpu"):
        assert make_production_mesh(multi_pod=True).shape == (2, 16, 16)
    if not torch.backends.cuda.is_built():
        with pytest.raises(RuntimeError, match="built without CUDA"):
            trace.fake_mode("cuda").__enter__()


# ---------------------------------------------------------------------------
# Records and tables
# ---------------------------------------------------------------------------


def test_records_and_tables_render(tmp_path, monkeypatch):
    for mod, attr, sub in ((dryrun, "RESULTS", "dryrun"),
                           (roofline, "RESULTS", "roofline"),
                           (report, "DRY", "dryrun"), (report, "ROOF", "roofline")):
        monkeypatch.setattr(mod, attr, tmp_path / sub)
    name, cut, kw = CELLS["decode"]
    rec = dryrun.lower_cell("qwen3-1.7b", name, cfg_override=reduced("qwen3-1.7b"),
                            shape_override=cut, mesh=(2, 2), device="cpu")
    path = tmp_path / "dryrun" / "qwen3-1.7b" / name / "2x2.baseline.json"
    assert json.loads(path.read_text()) == json.loads(json.dumps(rec))
    assert (path.parent / "2x2.baseline.schedule.txt").read_text().startswith(
        "all-")
    # the tables read the production mesh's names
    (path.parent / "16x16.baseline.json").write_text(path.read_text())
    table = report.dryrun_table()
    row = next(r for r in table.splitlines()
               if r.startswith(f"| qwen3-1.7b | {name} | 16x16 |"))
    assert "MISSING" not in row and str(rec["times"]["trace_s"]) in row
    assert "| whisper-medium | train_4k | 16x16 | MISSING |" in table
    roof = roofline.analyze_cell("qwen3-1.7b", name,
                                 cfg_override=reduced("qwen3-1.7b"),
                                 shape_override=cut, mesh=(2, 2), record=rec,
                                 device="cpu")
    assert roof["method"] == "dryrun record"
    assert roof["terms"]["step_lower_bound_s"] == max(
        roof["terms"]["compute_s"], roof["terms"]["memory_s"],
        roof["terms"]["collective_s"])
    src = tmp_path / "roofline" / "qwen3-1.7b" / name / "2x2.baseline.json"
    (src.parent / "16x16.baseline.json").write_text(src.read_text())
    row = next(r for r in report.roofline_table().splitlines()
               if r.startswith(f"| qwen3-1.7b | {name} |"))
    assert roof["terms"]["dominant"] in row


def test_roofline_constants_are_the_h100s():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.NET_BW) == (
        989e12, 3.35e12, 50e9)
    terms = roofline.roofline_terms({"flops": 989e12, "bytes": 3.35e12 * 2,
                                     "coll_bytes": 0.0})
    assert terms["dominant"] == "memory" and terms["step_lower_bound_s"] == 2.0


def test_dryrun_cli_tm_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)
    monkeypatch.setattr(dryrun, "run_tm", lambda async_votes, device: [
        dryrun.run_tm_checks(data=1, model=2, n_clauses=64, device=device)])
    dryrun.main(["--tm", "--device", "cpu"])
    assert "all engines OK" in capsys.readouterr().out
    assert json.loads((tmp_path / "tm" / "1x2.json").read_text())["failures"] == []
