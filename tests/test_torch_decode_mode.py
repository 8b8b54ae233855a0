"""The weight-stationary sharded decode step (``Policy.decode_mode``) of the
port on the CPU.

A decode step on a mesh keeps every weight on its rank and moves
activations only: the residual lies (rows, 1, d/|data|), each product
contracts a rank's ``data`` slice with its own weight shard, and the
partial sums are reduced into the batch layout the caches keep
(``sharding.psum_to_batch`` and friends). The MoE experts and RWKV-6 keep
their weight gathers, as the reference's compiled program does.

Checked here, at ``reduce_config`` widths:
  * the layout moves (``psum_to_batch``, ``stationary_to_batch``,
    ``batch_to_stationary``, ``gather_batch``) against gather and slice,
    exact, for every choice of batch axes on a (2, 2, 2) pod mesh;
  * per-device collective bytes of a traced decode step (B=4, cache 32,
    (2, 2)) at most 1.25× the reference's compiled program
    (``use_scan=False``, from one subprocess that compiles them all), and
    for the dense and whisper cells no more ``all_gather`` over ``data``
    than the reference's all-gather bytes;
  * float32 sharded decode against the unsharded port, 1e-5 of the
    largest magnitude (logits and every cache leaf; positions exact), over
    chained steps after a sharded prefill, on (1, 4), (2, 2), (2, 4) and
    a (2, 2, 2) pod mesh, and with batches that leave ``data`` (or every
    batch axis) out;
  * float32 against the same step with every weight gathered over
    ``data`` (a policy without ``decode_mode``), the oracle the
    weight-stationary step replaces, 1e-5.
"""
import dataclasses
import functools
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs, convert, steps
from repro_torch import sharding as S
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import DeviceMesh, axis_index, make_mesh
from repro_torch.models import model, transformer, whisper

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
BYTES_RATIO = 1.25
ARCHS = ("qwen3-1.7b", "qwen2-moe-a2.7b", "rwkv6-3b", "recurrentgemma-9b",
         "whisper-medium")
NO_WEIGHT_GATHER = ("qwen3-1.7b", "whisper-medium")
CONSTANT_AT_INIT = ("mu_x", "mu", "mu_k", "mu_r", "w0", "b_a", "b_i", "conv_b")

REFERENCE = textwrap.dedent("""
    import dataclasses, os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, "src")
    import jax
    from repro.configs import get_config, reduce_config
    from repro.configs.base import ShapeSpec
    from repro.launch.hlo import collective_stats
    from repro.launch.mesh import make_host_mesh, mesh_context
    from repro.sharding import named_shardings
    from repro.steps import make_step

    mesh = make_host_mesh(2, 2)
    out = {}
    for a in json.loads(sys.argv[1]):
        cfg = dataclasses.replace(reduce_config(get_config(a)), use_scan=False)
        step = make_step(cfg, ShapeSpec("d", "decode", 32, 4), mesh)
        with mesh_context(mesh):
            jitted = jax.jit(step.fn,
                             in_shardings=named_shardings(mesh, step.in_specs),
                             out_shardings=named_shardings(mesh, step.out_specs),
                             donate_argnums=(1,))
            text = jitted.lower(*step.arg_structs).compile().as_text()
        st = collective_stats(text)
        out[a] = {"total_bytes": st.total_bytes, "by_kind": st.by_kind,
                  "count": st.count}
    print(json.dumps(out))
""")


def compile_reference() -> dict:
    """Per arch: the reference's decode program's collective bytes per
    device (``total_bytes``, ``by_kind``) and count, from one subprocess."""
    res = subprocess.run([sys.executable, "-c", REFERENCE, json.dumps(ARCHS)],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def reference():
    pytest.importorskip("jax")
    return compile_reference()


@pytest.fixture
def float32_compute(monkeypatch):
    for mod in (transformer, whisper, steps):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)


def close(got, want, tol, what):
    """max |got - want| <= tol · max |want|."""
    got, want = got.detach().double(), want.detach().double()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    assert err <= tol * scale, f"{what}: max|diff| {err} > {tol} x {scale}"


def reduced(arch):
    return configs.reduce_config(configs.get_config(arch))


@functools.lru_cache(maxsize=None)
def weights(arch):
    """Float32 parameters of the reduced config from a seeded generator, the
    leaves that start constant (norms, RWKV-6's mixes, Griffin's biases)
    perturbed so their layouts show. Cached: callers must not modify them."""
    params = model.build(reduced(arch)).init(torch.Generator().manual_seed(3))
    rng = np.random.default_rng(12)
    with torch.no_grad():
        for name, p in params.named_parameters():
            last = name.split(".")[-1]
            if "scale" in name or last in CONSTANT_AT_INIT or last == "bias":
                p += torch.from_numpy(0.1 * rng.normal(size=p.shape).astype(
                    np.float32))
    return params


def pod_mesh():
    """A (2, 2, 2) mesh of the CPU: pod, data, model."""
    return DeviceMesh(devices=(torch.device("cpu"),) * 8, shape=(2, 2, 2))


def leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{path}/{k}")
    elif isinstance(tree, list) and not isinstance(tree, S.PerRank):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{path}/{i}")
    else:
        yield path, tree


# ---------------------------------------------------------------------------
# The layout moves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch_axes", [("pod", "data"), ("pod",), ("data",), ()])
def test_layout_moves_equal_gather_and_slice(batch_axes):
    """Rows (8, 1, d) laid out three ways: the residual (rows on the batch
    axes but ``data``, d on ``data``), the batch layout (rows on every
    batch axis, d whole), and partial sums over ``data`` of the residual's
    rows. Each move gives the other layout's shards exactly, and counts
    only collectives over ``data``."""
    mesh = pod_mesh()
    policy = dataclasses.replace(S.Policy.for_mesh(mesh), batch_axes=batch_axes)
    rest = tuple(a for a in batch_axes if a != "data")
    resid = S.P(rest or None, None, "data")
    batch = S.P(batch_axes or None, None, None)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(8, 1, 6))
                         .astype(np.float32))
    xs = S.shard(x, resid, mesh)
    mesh.collectives.reset()
    to_b = S.stationary_to_batch(xs, policy)
    assert all(torch.equal(a, b) for a, b in zip(to_b, S.shard(x, batch, mesh)))
    back = S.batch_to_stationary(to_b, policy)
    assert all(torch.equal(a, b) for a, b in zip(back, xs))
    rows = S.shard(x[..., :2], S.P(batch_axes or None), mesh)
    assert all(torch.equal(a, b) for a, b in zip(
        S.gather_batch(rows, policy), S.shard(x[..., :2], S.P(rest or None), mesh)))
    parts = S.PerRank(t * (1 + axis_index(mesh, r, "data"))
                      for r, t in enumerate(S.shard(x, S.P(rest or None), mesh)))
    summed = S.psum_to_batch(parts, policy)
    want = S.shard(3 * x, batch, mesh)
    assert all(torch.equal(a, b) for a, b in zip(summed, want))
    assert all(k.endswith("/data") for k in mesh.collectives.calls)


# ---------------------------------------------------------------------------
# Against the reference's compiled program
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def traced(arch):
    cfg = reduced(arch)
    over = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return dryrun.lower_cell(arch, "decode_32k", cfg_override=over,
                             shape_override={"seq_len": 32, "global_batch": 4},
                             mesh=(2, 2), device="cpu", save=False)["collectives"]


@pytest.mark.parametrize("arch", ARCHS)
def test_collective_bytes_within_the_reference(reference, arch):
    """Per-device collective bytes of a decode step at most 1.25× the
    reference's program's; weight-stationary cells gather no weight."""
    got, want = traced(arch), reference[arch]
    assert got["total_bytes"] <= BYTES_RATIO * want["total_bytes"], (
        got["total_bytes"], want["total_bytes"])
    if arch in NO_WEIGHT_GATHER:
        assert (got["by_call"].get("all_gather/data", 0)
                <= want["by_kind"].get("all-gather", 0))


# ---------------------------------------------------------------------------
# Float32 against the unsharded port
# ---------------------------------------------------------------------------


def serve(arch, mesh, batch, steps_n=3, prompt=4, cache_len=16):
    """Sharded prefill of ``prompt`` tokens then ``steps_n`` chained decode
    steps beside the unsharded port: [(sharded, unsharded) logits], the
    gathered sharded cache, the unsharded cache, the decode policy."""
    cfg = reduced(arch)
    params = weights(arch)
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, prompt + steps_n))
                            .astype(np.int32))
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = torch.from_numpy(
            (0.5 * rng.normal(size=(batch, cfg.enc_seq, cfg.d_model)))
            .astype(np.float32))
    m = model.build(cfg)
    pstep = steps.make_prefill_step(
        cfg, ShapeSpec("p", "prefill", cache_len, batch), mesh)
    dstep = steps.make_decode_step(
        cfg, ShapeSpec("d", "decode", cache_len, batch), mesh)
    sp = convert.shard_lm(params, mesh)
    inputs = {"tokens": toks[:, :prompt], **extra}
    lg, cache = pstep.fn(sp, S.shard_tree(inputs, pstep.in_specs[1], mesh))
    want, rcache = m.prefill(params, cache_len, **inputs)
    pairs = [(S.gather(lg, pstep.out_specs[0], mesh), want)]
    for i in range(prompt, prompt + steps_n):
        pos = torch.full((batch,), i, dtype=torch.int32)
        pos[0] += 1                                # rows at different slots
        tok = toks[:, i:i + 1]
        lg, cache = dstep.fn(sp, cache, S.shard(tok, dstep.in_specs[2], mesh),
                             S.shard(pos, dstep.in_specs[3], mesh))
        want, rcache = m.decode_step(params, tok, rcache, pos)
        pairs.append((S.gather(lg, dstep.out_specs[0], mesh), want))
    return pairs, S.gather_tree(cache, dstep.out_specs[1], mesh), rcache, dstep


MESHES = {"1x4": lambda: make_mesh(1, 4, device="cpu"),
          "2x2": lambda: make_mesh(2, 2, device="cpu"),
          "2x4": lambda: make_mesh(2, 4, device="cpu"),
          "2x2x2": pod_mesh}


@pytest.mark.parametrize("mesh_name", tuple(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_equals_unsharded(arch, mesh_name, float32_compute):
    pairs, cache, rcache, _ = serve(arch, MESHES[mesh_name](), 4)
    for i, (got, want) in enumerate(pairs):
        close(got, want, TOL, f"{arch} {mesh_name} step {i}")
    want = dict(leaves(rcache))
    for path, got in leaves(cache):
        if got.dtype == torch.int32:
            assert torch.equal(got, want[path]), path
        else:
            close(got, want[path], TOL, f"{arch} {mesh_name} cache {path}")


@pytest.mark.parametrize("mesh_name,batch,axes", [
    ("2x2", 3, ()), ("2x2x2", 2, ("pod",)), ("2x2x2", 3, ())])
@pytest.mark.parametrize("arch", ("qwen3-1.7b", "recurrentgemma-9b",
                                  "whisper-medium"))
def test_decode_equals_unsharded_for_every_batch_layout(arch, mesh_name, batch,
                                                        axes, float32_compute):
    """A batch that ``data`` does not divide keeps the rows whole over
    ``data`` (a psum instead of the reduce-scatter), one that only the
    pod divides splits them over ``pod`` alone."""
    pairs, _, _, dstep = serve(arch, MESHES[mesh_name](), batch, steps_n=2)
    assert dstep.out_specs[0] == (S.P(axes) if axes else S.P())
    for i, (got, want) in enumerate(pairs):
        close(got, want, TOL, f"{arch} {mesh_name} B={batch} step {i}")


def clone(tree):
    """A copy of a cache tree of ``PerRank`` leaves (decode writes in place)."""
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, S.PerRank):
        return S.PerRank(t.clone() for t in tree)
    return [clone(v) for v in tree]


@pytest.mark.parametrize("arch", ARCHS)
def test_stationary_decode_equals_the_gathered_decode(arch, float32_compute):
    """The weight-stationary step against the same step with every weight
    gathered over ``data`` (a policy without ``decode_mode``, the layout the
    reference's partitioner falls back to), from one sharded prefill on
    (2, 4): logits and every cache leaf 1e-5 of the largest, positions
    equal, over three chained steps."""
    cfg = reduced(arch)
    mesh = make_mesh(2, 4, device="cpu")
    batch, prompt = 4, 4
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, prompt + 3))
                            .astype(np.int32))
    inputs = {"tokens": toks[:, :prompt]}
    if cfg.family == "encdec":
        inputs["frames"] = torch.from_numpy(
            (0.5 * rng.normal(size=(batch, cfg.enc_seq, cfg.d_model)))
            .astype(np.float32))
    pstep = steps.make_prefill_step(cfg, ShapeSpec("p", "prefill", 16, batch),
                                    mesh)
    dstep = steps.make_decode_step(cfg, ShapeSpec("d", "decode", 16, batch),
                                   mesh)
    sp = convert.shard_lm(weights(arch), mesh)
    _, cache = pstep.fn(sp, S.shard_tree(inputs, pstep.in_specs[1], mesh))
    gathered = dataclasses.replace(S.Policy.for_mesh(mesh),
                                   batch_axes=steps.batch_axes_for(batch, mesh))
    m = model.build(cfg)
    other = clone(cache)
    for i in range(prompt, prompt + 3):
        tok = S.shard(toks[:, i:i + 1], dstep.in_specs[2], mesh)
        pos = S.shard(torch.full((batch,), i, dtype=torch.int32),
                      dstep.in_specs[3], mesh)
        got, cache = dstep.fn(sp, cache, tok, pos)
        with torch.no_grad():
            want, other = m.decode_step(sp, tok, other, pos, policy=gathered)
        close(S.gather(got, dstep.out_specs[0], mesh),
              S.gather(want, dstep.out_specs[0], mesh), TOL, f"{arch} step {i}")
    want = dict(leaves(S.gather_tree(other, dstep.out_specs[1], mesh)))
    for path, got in leaves(S.gather_tree(cache, dstep.out_specs[1], mesh)):
        if got.dtype == torch.int32:
            assert torch.equal(got, want[path]), path
        else:
            close(got, want[path], TOL, f"{arch} cache {path}")


if __name__ == "__main__":
    # the table PERF.md quotes: per-device collective bytes of one decode
    # step, the port's trace against the reference's compiled program
    want = compile_reference()
    print("arch | port bytes (calls) | all_gather/data | reference bytes "
          "(collectives) | all-gather | ratio")
    for arch in ARCHS:
        got, ref = traced(arch), want[arch]
        print(f"{arch} | {got['total_bytes']} ({got['count']}) | "
              f"{got['by_call'].get('all_gather/data', 0)} | "
              f"{ref['total_bytes']} ({ref['count']}) | "
              f"{ref['by_kind'].get('all-gather', 0)} | "
              f"{got['total_bytes'] / ref['total_bytes']:.3f}")
