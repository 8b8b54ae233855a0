"""The port's sharded LM path (``repro_torch.sharding``, the ``*_sharded``
model functions, ``models/pipeline.py`` and the steps on a mesh) on the CPU.

Meshes are single-controller ``make_mesh(..., device="cpu")`` grids at
(1, 4), (2, 2) and (2, 4): no subprocess and no forced JAX device count.
The reference's specs come from its own functions, its meshes replaced by
a stand-in that has ``axis_names`` and ``devices.shape``.

Tolerances: specs and layouts exact; float32 sharded against unsharded
1e-5 of the largest magnitude (reduction order is all that differs: the
row-parallel partial sums, the flash-decode combine, the vocab-split
logsumexp); the MoE engine 1e-5 relative and ``aux`` 1e-6; ``gpipe_apply``
1e-6; bf16 greedy tokens equal. Under int8 compression a gradient that
moves by reduction order may round to the neighbouring level, so the
compressed gradients are held to one quantisation step.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import sharding as jsharding  # noqa: E402
from repro import steps as jsteps  # noqa: E402
from repro.configs.base import ShapeSpec as JShapeSpec  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402

from repro_torch import configs, convert, steps  # noqa: E402
from repro_torch import sharding as S  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    axis_groups,
    axis_index,
    axis_ranks,
    axis_size,
    make_mesh,
)
from repro_torch.models import attention, model, transformer  # noqa: E402
from repro_torch.models.moe import init_moe, moe_block  # noqa: E402
from repro_torch.models.pipeline import gpipe_apply  # noqa: E402
from repro_torch.optim import adamw, compression  # noqa: E402

TOL = 1e-5
MESHES = ((1, 4), (2, 2), (2, 4))
FAMILY_ARCHS = ("qwen3-1.7b", "qwen2-moe-a2.7b")
BIG = 1_000_000


def close(got, want, tol, what):
    """max |got - want| <= tol · max |want|."""
    got = np.asarray(got.detach().double() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want.detach().double() if isinstance(want, torch.Tensor)
                      else want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, f"{what}: max|diff| {err} > {tol} x {scale}"


@pytest.fixture
def float32_compute(monkeypatch):
    for mod in (transformer, steps):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)
    for mod in (jtransformer, jsteps, jmodel):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)


def stand_in(data, model_):
    """The reference's view of a (data, model) mesh: names and a shape."""
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((data, model_), object))


def jspec(spec):
    """A reference PartitionSpec as a plain tuple."""
    return tuple(spec)


def reduced(arch):
    """The reference sharded test's reduced width for qwen3 (2 layers, d 64,
    4 heads, 2 K/V heads, head_dim 16, d_ff 128, vocab 256); the MoE with
    4 experts of 32, top-2 and a shared expert of 64."""
    cfg = dataclasses.replace(
        configs.get_config(arch), n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=256, remat=False)
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, n_experts=4, top_k=2, d_ff_expert=32,
                                  d_ff_shared=64)
    return cfg


def meta_module(cfg):
    return steps._meta_module(cfg)


# ---------------------------------------------------------------------------
# Rules and specs against the reference
# ---------------------------------------------------------------------------


def reference_specs(arch):
    """(spec by "/"-joined stacked path, leaf shapes) of the reference's
    ``param_specs`` at full width, traced (``eval_shape``) and not run."""
    cfg = jconfigs.get_config(arch)
    m = jmodel.build(cfg)
    if cfg.family == "encdec":
        struct = jax.eval_shape(lambda: m.init(jax.random.key(0), 4096))
    else:
        struct = jax.eval_shape(lambda: m.init(jax.random.key(0)))
    specs = jsharding.param_specs(struct, stacked_prefixes=("layers",
                                                            "enc_layers"))
    flat_s = jax.tree_util.tree_flatten_with_path(struct)[0]
    flat_p = jax.tree_util.tree_flatten(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    out = {}
    for (kp, leaf), spec in zip(flat_s, flat_p):
        path = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)
        out[path] = (jspec(spec), leaf.shape)
    return out


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_param_specs_match_reference(arch):
    """Every port parameter's spec is the reference's spec of the leaf it
    comes from (``convert._lm_target`` maps the leaf to it), without the
    stacked dim, reversed for an ``nn.Linear``; every reference leaf is
    some parameter's."""
    ref = reference_specs(arch)
    module = meta_module(configs.get_config(arch))
    names = {n for n, _ in module.named_parameters()}
    specs = S.param_specs(module)
    seen = set()
    for name, p in module.named_parameters():
        path, transposed = S.reference_path(name, module)
        spec, shape = ref[path]
        stacked = path.split("/")[0] in ("layers", "enc_layers")
        if stacked:
            spec, shape = spec[1:], shape[1:]
            layer = name.split(".")[1]
            parts = path.split("/")
            target = (parts[0], layer) + tuple(parts[1:])
        else:
            target = tuple(path.split("/"))
        assert convert._lm_target(target, names) == (name, transposed), name
        if transposed:
            spec, shape = tuple(reversed(spec)), tuple(reversed(shape))
        assert tuple(p.shape) == tuple(shape), name
        assert tuple(specs[name]) == spec, (name, specs[name], spec)
        seen.add(path)
    assert seen == set(ref)


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_big_params_are_sharded(arch):
    """No parameter of 1M elements or more (per layer) is replicated."""
    module = meta_module(configs.get_config(arch))
    specs = S.param_specs(module)
    offenders = [(n, tuple(p.shape)) for n, p in module.named_parameters()
                 if p.numel() >= BIG and all(s is None for s in specs[n])]
    assert not offenders, offenders


def port_tree(specs):
    """A port spec tree with plain tuples for comparison."""
    if isinstance(specs, S.P):
        return tuple(specs)
    if isinstance(specs, dict):
        return {k: port_tree(v) for k, v in specs.items()}
    return [port_tree(v) for v in specs]


def ref_tree(specs):
    if isinstance(specs, jax.sharding.PartitionSpec):
        return jspec(specs)
    if isinstance(specs, dict):
        return {k: ref_tree(v) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)) and not hasattr(specs, "_fields"):
        return [ref_tree(v) for v in specs]
    return type(specs)(*(ref_tree(v) for v in specs))


def by_port_name(cfg, jspecs, names):
    """A reference param-spec tree keyed by the port's names (the stacked
    dim dropped, reversed for an ``nn.Linear``)."""
    module = meta_module(cfg)
    flat = {}

    def walk(t, path):
        if isinstance(t, jax.sharding.PartitionSpec):
            flat["/".join(path)] = jspec(t)
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (str(k),))
        else:
            for i, v in enumerate(t):
                walk(v, path + (str(i),))

    walk(jspecs, ())
    out = {}
    for name in names:
        path, transposed = S.reference_path(name, module)
        spec = flat[path]
        if path.split("/")[0] in ("layers", "enc_layers"):
            spec = spec[1:]
        out[name] = tuple(reversed(spec)) if transposed else spec
    return out


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_step_specs_match_reference(arch):
    """``in_specs`` / ``out_specs`` of the train, prefill and decode steps
    on a (2, 4) mesh equal the reference's (at ``reduce_config`` width:
    the specs do not depend on widths), caches of every family included."""
    cfg = configs.reduce_config(configs.get_config(arch))
    jcfg = jconfigs.reduce_config(jconfigs.get_config(arch))
    mesh, jmesh = make_mesh(2, 4, device="cpu"), stand_in(2, 4)
    shapes = (("train", 16, 8), ("prefill", 16, 4), ("decode", 16, 4))
    for kind, seq, batch in shapes:
        shape, jshape = (ShapeSpec(kind, kind, seq, batch),
                         JShapeSpec(kind, kind, seq, batch))
        kw = dict(microbatches=2) if kind == "train" else {}
        got = steps.make_step(cfg, shape, mesh, **kw)
        want = jsteps.make_step(jcfg, jshape, jmesh, **kw)
        names = list(got.in_specs[0]["params"] if kind == "train"
                     else got.in_specs[0])
        if kind == "train":
            st_g, st_w = got.in_specs[0], want.in_specs[0]
            for part in ("params",):
                assert port_tree(st_g[part]) == by_port_name(cfg, st_w[part], names)
            assert tuple(st_g["opt"].step) == jspec(st_w["opt"].step)
            for g, w in ((st_g["opt"].mu, st_w["opt"].mu),
                         (st_g["opt"].nu, st_w["opt"].nu),
                         (st_g["ef"].residual, st_w["ef"].residual)):
                assert port_tree(g) == by_port_name(cfg, w, names)
            assert port_tree(got.in_specs[1]) == ref_tree(want.in_specs[1])
            assert tuple(got.out_specs[1]) == jspec(want.out_specs[1])
            assert port_tree(got.out_specs[0]["params"]) == by_port_name(
                cfg, want.out_specs[0]["params"], names)
        else:
            assert port_tree(got.in_specs[0]) == by_port_name(
                cfg, want.in_specs[0], names)
            rest_g = [port_tree(s) for s in got.in_specs[1:]]
            rest_w = [ref_tree(s) for s in want.in_specs[1:]]
            assert rest_g == rest_w, kind
            assert ([port_tree(s) for s in got.out_specs]
                    == [ref_tree(s) for s in want.out_specs]), kind


@pytest.mark.parametrize("batch,shape", [(8, (2, 4)), (4, (2, 2)), (3, (2, 4)),
                                         (2, (1, 4)), (6, (4, 2))])
def test_batch_axes_for_matches_reference(batch, shape):
    mesh = make_mesh(*shape, device="cpu")
    assert steps.batch_axes_for(batch, mesh) == jsteps.batch_axes_for(
        batch, stand_in(*shape))
    assert steps.batch_axes_for(batch, None) == jsteps.batch_axes_for(batch, None)


def test_policy_specs_match_reference():
    mesh = make_mesh(2, 4, device="cpu")
    for kw in ({}, {"decode_mode": True}, {"seq_shard_residual": False},
               {"batch_axes": ()}):
        got = dataclasses.replace(S.Policy.for_mesh(mesh), **kw)
        want = dataclasses.replace(jsharding.Policy.for_mesh(stand_in(2, 4)),
                                   **kw)
        assert got.b == want.b
        for fn in ("act_btd", "act_btd_tp", "act_residual", "act_heads",
                   "kv_cache", "logits"):
            seen = {}
            orig = jax.lax.with_sharding_constraint
            try:
                jax.lax.with_sharding_constraint = (
                    lambda x, s: seen.setdefault("s", s))
                getattr(want, fn)(None)
            finally:
                jax.lax.with_sharding_constraint = orig
            assert tuple(getattr(got, fn)()) == jspec(seen["s"]), (kw, fn)
    assert not S.Policy.none().active


# ---------------------------------------------------------------------------
# Layouts, the mesh and the collectives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", MESHES)
def test_shard_tree_round_trips_and_raises(shape):
    mesh = make_mesh(*shape, device="cpu")
    rng = np.random.default_rng(0)
    tree = {"a": torch.from_numpy(rng.normal(size=(8, 12)).astype(np.float32)),
            "b": [torch.arange(16, dtype=torch.int32).reshape(4, 4)],
            "c": adamw.AdamWState(torch.zeros((), dtype=torch.int32),
                                  {"w": torch.ones(4, 8)}, {"w": torch.ones(4, 8)})}
    specs = {"a": S.P("data", "model"), "b": [S.P(None, ("data", "model"))],
             "c": adamw.AdamWState(S.P(), {"w": S.P("model")}, {"w": S.P()})}
    if shape == (2, 4):
        specs["b"] = [S.P(("data",), None)]
    sharded = S.shard_tree(tree, specs, mesh)
    assert isinstance(sharded["a"], S.PerRank) and len(sharded["a"]) == mesh.size
    d, m = shape
    assert sharded["a"][0].shape == (8 // d, 12 // m)
    back = S.gather_tree(sharded, specs, mesh)
    for got, want in ((back["a"], tree["a"]), (back["b"][0], tree["b"][0]),
                      (back["c"].mu["w"], tree["c"].mu["w"]),
                      (back["c"].step, tree["c"].step)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="divisible"):
        S.shard_tree({"x": torch.zeros(6, 5)}, {"x": S.P(None, "model")}, mesh)
    assert S.tree_bytes(sharded["a"]) == [8 * 12 * 4 // (d * m)] * mesh.size


def test_mesh_axes_and_collectives():
    mesh = make_mesh(2, 4, device="cpu")
    assert axis_size(mesh, "model") == 4 and axis_size(mesh, ("data", "model")) == 8
    assert axis_groups(mesh, "data") == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert axis_ranks(mesh, 6, "model") == [4, 5, 6, 7]
    assert [axis_index(mesh, r, "model") for r in range(8)] == [0, 1, 2, 3] * 2
    xs = S.PerRank(torch.full((2,), float(r)) for r in range(8))
    mesh.collectives.reset()
    s = S.psum(xs, mesh, "model")
    assert [float(t[0]) for t in s] == [6.0] * 4 + [22.0] * 4
    assert s[0] is not s[1]                      # every rank its own copy
    assert [float(t[0]) for t in S.pmax(xs, mesh, "data")] == [4, 5, 6, 7] * 2
    assert [float(t[0]) for t in S.pmean(xs, mesh, "data")] == [2, 3, 4, 5] * 2
    g = S.all_gather(xs, mesh, "model", 0)
    assert g[5].tolist() == [4, 4, 5, 5, 6, 6, 7, 7]
    rs = S.psum_scatter(S.PerRank(torch.arange(8.0) for _ in range(8)), mesh,
                        "model", 0)
    assert rs[2].tolist() == [16.0, 20.0]
    pp = S.ppermute(xs, mesh, "model", [(0, 1), (1, 2), (2, 3), (3, 0)])
    assert [float(t[0]) for t in pp] == [3, 0, 1, 2, 7, 4, 5, 6]
    calls = mesh.collectives.snapshot()["calls"]
    assert calls == {"psum/model": 1, "pmax/data": 1, "pmean/data": 1,
                     "all_gather/model": 1, "psum_scatter/model": 1,
                     "ppermute/model": 1}
    assert mesh.collectives.bytes["psum/model"] == 8 * 2 * 4
    one = make_mesh(1, 4, device="cpu")
    S.psum(S.PerRank(torch.ones(1) for _ in range(4)), one, "data")
    assert not one.collectives.calls               # a group of one moves nothing


def test_global_norm_counts_replicas_once_and_int8_scale_is_global():
    mesh = make_mesh(2, 2, device="cpu")
    rng = np.random.default_rng(3)
    full = {"w": torch.from_numpy(rng.normal(size=(4, 6)).astype(np.float32)),
            "s": torch.from_numpy(rng.normal(size=(6,)).astype(np.float32))}
    specs = {"w": S.P("model", "data"), "s": S.P()}
    g = S.shard_tree(full, specs, mesh)
    got = adamw.global_norm_sharded(g, specs, mesh)
    want = adamw.global_norm(full)
    for t in got:
        assert abs(float(t) - float(want)) <= 1e-6 * float(want)
    ef = compression.ErrorFeedback(S.shard_tree(
        {k: torch.zeros_like(v) for k, v in full.items()}, specs, mesh))
    comp, res = compression.compress_grads_sharded(g, ef, specs, mesh,
                                                   mode="int8")
    want_c, want_ef = compression.compress_grads(
        full, compression.ErrorFeedback({k: torch.zeros_like(v)
                                         for k, v in full.items()}), mode="int8")
    for k in full:
        assert torch.equal(S.gather(comp[k], specs[k], mesh), want_c[k])
        assert torch.equal(S.gather(res.residual[k], specs[k], mesh),
                           want_ef.residual[k])


# ---------------------------------------------------------------------------
# Flash-decode, the MoE engine, gpipe
# ---------------------------------------------------------------------------


def shard_block(module, prefix, mesh, extra=None):
    """Rank views of ``module`` laid out by its specs under ``prefix``,
    gathered over ``data`` (and ``extra``) as a block gathers them."""
    specs = S.param_specs(module, prefix)
    sm = S.shard_module(module, mesh, specs=specs)
    views = [sm.rank_view(r) for r in range(mesh.size)]
    return S.gather_params(views, specs, mesh, extra=extra), specs


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", ["full", "window", "rolling"])
@pytest.mark.parametrize("kv", [2, 4])
def test_decode_attend_sharded_matches_single_device(shape, case, kv):
    """Four float32 decode steps: outputs 1e-5 of max|out|, the gathered
    cache equal to the single-device cache bit for bit. ``rolling``: a
    cache of 8 slots at positions 14–17, so the slot wraps and crosses
    shards; ``window`` masks to the last 5 positions."""
    mesh = make_mesh(*shape, device="cpu")
    gen = torch.Generator().manual_seed(1)
    h, dh, d, b = 4, 8, 32, 4
    att = attention.init_attention(gen, d, h, kv, dh, qk_norm=True)
    clen = 8 if case == "rolling" else 16
    window = 5 if case == "window" else None
    start = 14 if case == "rolling" else 6
    rng = np.random.default_rng(2)
    cache = attention.init_cache(b, clen, kv, dh, dtype=torch.float32)
    cache["k"].copy_(torch.from_numpy(rng.normal(size=cache["k"].shape)))
    cache["v"].copy_(torch.from_numpy(rng.normal(size=cache["v"].shape)))
    filled = np.arange(start - clen, start) if case == "rolling" else np.arange(start)
    pos = torch.full((b, clen), -1, dtype=torch.int32)
    pos[:, torch.from_numpy(filled % clen)] = torch.from_numpy(filled).int()
    cache["pos"].copy_(pos)
    specs = {"k": S.P(("data",), None, "model", None), "v": S.P(("data",), None,
                                                                 "model", None),
             "pos": S.P(("data",), "model")}
    sharded = S.shard_tree(cache, specs, mesh)
    caches = [{n: t[r] for n, t in sharded.items()} for r in range(mesh.size)]
    ps, _ = shard_block(att, "attn/", mesh, attention.kv_extra_gather(
        kv, axis_size(mesh, "model")))
    kw = dict(n_heads=h, n_kv_heads=kv, head_dim=dh, rope_theta=1e4,
              window=window)
    for i in range(4):
        x = torch.from_numpy(rng.normal(size=(b, 1, d)).astype(np.float32))
        p_b = torch.full((b,), start + i, dtype=torch.int32)
        p_b[1] += 1                               # rows at different slots
        want, cache = attention.decode_attend(att, x, cache, p_b, **kw)
        xs = S.shard(x, S.P(("data",)), mesh)
        pbs = S.shard(p_b, S.P(("data",)), mesh)
        ys, caches = attention.decode_attend_sharded(
            ps, xs, caches, pbs,
            mesh=mesh, **kw)
        got = S.gather(S.psum(ys, mesh, "model"), S.P(("data",)), mesh)
        close(got, want, TOL, f"step {i}")
    for n in specs:
        got = S.gather(S.PerRank(c[n] for c in caches), specs[n], mesh)
        assert torch.equal(got, cache[n]), n


@pytest.mark.parametrize("dispatch", ["sort", "einsum"])
@pytest.mark.parametrize("shape", [(2, 4), (2, 2)])
def test_moe_shard_map_matches_local_engine(dispatch, shape):
    """The reference test's MoE (d 32, f 16, 4 experts, top-2, capacity
    factor 1.5, drops on): out 1e-5 relative, aux 1e-6, one psum over
    ``model``."""
    mesh = make_mesh(*shape, device="cpu")
    pm = init_moe(torch.Generator().manual_seed(3), 32, 16, 4)
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=(4, 8, 32)) * 0.3).astype(np.float32))
    kw = dict(top_k=2, capacity_factor=1.5, dispatch=dispatch)
    want, aux_want = moe_block(pm, x, **kw)
    specs = S.param_specs(pm, "moe/")
    sm = S.shard_module(pm, mesh, specs=specs)
    policy = S.Policy.for_mesh(mesh)
    mesh.collectives.reset()
    outs, aux = moe_block([sm.rank_view(r) for r in range(mesh.size)],
                          S.shard(x, S.P(("data",)), mesh), policy=policy, **kw)
    assert mesh.collectives.calls["psum/model"] == 1
    assert mesh.collectives.calls["all_gather/data"] == 4
    close(S.gather(outs, S.P(("data",)), mesh), want, TOL, "moe out")
    want_aux = float(aux_want.detach())
    for a in aux:
        assert abs(float(a.detach()) - want_aux) <= 1e-6 * abs(want_aux)


@pytest.mark.parametrize("n_stages,n_micro,shape,axis",
                         [(2, 6, (2, 4), "data"), (4, 3, (1, 4), "model"),
                          (4, 6, (2, 4), "model")])
def test_gpipe_matches_reference_sequential_stack(n_stages, n_micro, shape, axis):
    """The reference test's ``tanh(x @ W)`` stage; the JAX package's
    sequential stack is the reference (1e-6)."""
    mesh = make_mesh(*shape, device="cpu")
    mb, d = 2, 16
    ws = (np.random.default_rng(1).normal(size=(n_stages, d, d)) * 0.3).astype(
        np.float32)
    xs = np.random.default_rng(2).normal(size=(n_micro, mb, d)).astype(np.float32)
    ref = jnp.asarray(xs)
    for s in range(n_stages):
        ref = jnp.tanh(ref @ jnp.asarray(ws[s]))
    mesh.collectives.reset()
    outs = gpipe_apply(lambda w, x: torch.tanh(x @ w), torch.from_numpy(ws),
                       torch.from_numpy(xs), mesh=mesh, axis=axis)
    assert mesh.collectives.calls[f"ppermute/{axis}"] == n_micro + n_stages - 1
    for out in outs:
        close(out, np.asarray(ref), 1e-6, "gpipe")


# ---------------------------------------------------------------------------
# The steps on a mesh against the unsharded port
# ---------------------------------------------------------------------------


def serve_batch(cfg, b, t, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (b, t)).astype(np.int32))


def run_serving(cfg, params, mesh, toks, prompt, cache_len, vision=None):
    """Sharded prefill of ``prompt`` tokens then decode of the rest, beside
    the unsharded port; returns [(sharded logits, unsharded logits)] and
    the two final caches."""
    b, t = toks.shape
    m = model.build(cfg)
    pshape = ShapeSpec("p", "prefill", cache_len, b)
    pstep = steps.make_prefill_step(cfg, pshape, mesh)
    dstep = steps.make_decode_step(cfg, ShapeSpec("d", "decode", cache_len, b),
                                   mesh)
    sp = convert.shard_lm(params, mesh)
    batch = {"tokens": toks[:, :prompt]}
    if vision is not None:
        batch["vision_embeds"] = vision
    lg, cache = pstep.fn(sp, S.shard_tree(batch, pstep.in_specs[1], mesh))
    want, rcache = m.prefill(params, cache_len, **batch)
    out = [(S.gather(lg, pstep.out_specs[0], mesh), want)]
    off = 0 if vision is None else cfg.n_vision_tokens
    for i in range(prompt, t):
        p_b = torch.full((b,), i + off, dtype=torch.int32)
        lg, cache = dstep.fn(sp, cache, S.shard(toks[:, i:i + 1],
                                                dstep.in_specs[2], mesh),
                             S.shard(p_b, dstep.in_specs[3], mesh))
        want, rcache = m.decode_step(params, toks[:, i:i + 1], rcache, p_b)
        out.append((S.gather(lg, dstep.out_specs[0], mesh), want))
    return out, S.gather_tree(cache, dstep.out_specs[1], mesh), rcache


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_sharded_prefill_and_decode_match_unsharded(arch, shape, float32_compute):
    """Prefill of 4 tokens and 8 decode steps, float32: every logit row
    1e-5 of max|logit|; the gathered cache 1e-5 of max|cache|."""
    cfg = reduced(arch)
    params = model.build(cfg).init(torch.Generator().manual_seed(0))
    toks = serve_batch(cfg, 4, 12)
    pairs, cache, rcache = run_serving(cfg, params, make_mesh(*shape, device="cpu"),
                                       toks, 4, 16)
    for i, (got, want) in enumerate(pairs):
        close(got, want, TOL, f"{arch} {shape} step {i}")
    for key, block in rcache["layers"].items():
        for n, t in block.items():
            close(cache["layers"][key][n], t, TOL, f"cache {key}/{n}")


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_sharded_bf16_greedy_tokens_match(arch):
    """bf16 (the compute dtype): the argmax of every step equal, as the
    reference's sharded test asserts."""
    cfg = reduced(arch)
    params = model.build(cfg).init(torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    pairs, _, _ = run_serving(cfg, params, make_mesh(2, 4, device="cpu"),
                              serve_batch(cfg, 2, 8), 1, 16)
    for got, want in pairs:
        assert torch.equal(got.argmax(-1), want.argmax(-1))


def test_sharded_vlm_prefill_matches_unsharded(float32_compute):
    """llava at reduced width (vision positions ahead of the text) through
    the sharded prefill and two decode steps."""
    cfg = configs.reduce_config(configs.get_config("llava-next-mistral-7b"))
    params = model.build(cfg).init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(4)
    vision = torch.from_numpy(rng.normal(size=(2, cfg.n_vision_tokens,
                                               cfg.d_model)).astype(np.float32))
    toks = serve_batch(cfg, 2, 6)
    clen = 4 * ((cfg.n_vision_tokens + 6 + 3) // 4)
    pairs, _, _ = run_serving(cfg, params, make_mesh(2, 2, device="cpu"), toks, 4,
                              clen, vision=vision)
    for i, (got, want) in enumerate(pairs):
        close(got, want, TOL, f"vlm step {i}")


def train_state(cfg, seed=0):
    return steps.init_train_state(model.build(cfg).init(
        torch.Generator().manual_seed(seed)))


@pytest.mark.parametrize("compress", ["none", "int8"])
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_sharded_train_step_matches_unsharded(arch, shape, compress,
                                              float32_compute):
    """One step, M=2, ``peak_lr=0`` (so the first moment holds the clipped
    compressed gradients and the residual what compression dropped), float32:
    loss and NLL 1e-5; the gradients before compression (``mu`` unclipped
    plus the residual) 1e-5 of max|g|; int8's compressed gradients within
    one quantisation step of the tensor's own scale; the parameters
    unchanged and the step counted on every rank."""
    cfg = reduced(arch)
    mesh = make_mesh(*shape, device="cpu")
    b, t = 8, 8
    rng = np.random.default_rng(5)
    batch = {"tokens": serve_batch(cfg, b, t, 6),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (b, t))
                                        .astype(np.int32))}
    kw = dict(microbatches=2, compress=compress, peak_lr=0.0, warmup_steps=0,
              total_steps=10)
    shape_ = ShapeSpec("t", "train", t, b)
    want_state, want = steps.make_train_step(cfg, shape_, **kw).fn(
        train_state(cfg), dict(batch))
    tstep = steps.make_train_step(cfg, shape_, mesh, **kw)
    state = convert.shard_train_state(train_state(cfg), mesh)
    state, got = tstep.fn(state, S.shard_tree(batch, tstep.in_specs[1], mesh))
    for key in ("loss", "nll", "grad_norm"):
        close(got[key], want[key], TOL, key)
    whole = convert.gather_train_state(state)
    scale_g = 0.1 * min(1.0, 1.0 / float(want["grad_norm"]))
    gs = {n: want_state["opt"].mu[n] / scale_g + want_state["ef"].residual[n]
          for n in want_state["opt"].mu}
    top = max(float(g.abs().max()) for g in gs.values())
    scale_s = 0.1 * min(1.0, 1.0 / float(got["grad_norm"]))
    for n, g in gs.items():
        raw = whole["opt"].mu[n] / scale_s + whole["ef"].residual[n]
        assert float((raw - g).abs().max()) <= TOL * top, n
        if compress == "int8":
            step = float(g.abs().max()) / 127
            diff = (whole["opt"].mu[n] / scale_s - want_state["opt"].mu[n] / scale_g)
            assert float(diff.abs().max()) <= step * (1 + 1e-4) + TOL * top, n
        else:
            close(whole["opt"].mu[n], want_state["opt"].mu[n], TOL, n)
    for n, p in whole["params"].named_parameters():
        assert torch.equal(p, dict(want_state["params"].named_parameters())[n])
    assert [int(s) for s in state["opt"].step] == [1] * mesh.size


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


def reference_tree(jcfg, params):
    """The port's ``params`` as the reference's tree (stacked, transposed
    back where an ``nn.Linear`` holds it)."""
    named = {n: p.detach().numpy() for n, p in params.named_parameters()}

    def get(path):
        name, transpose = convert._lm_target(path, set(named))
        return named[name].T if transpose else named[name]

    def leaf(path, struct):
        keys = tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        if keys[0] == "layers":
            return np.stack([get((keys[0], str(j)) + keys[1:])
                             for j in range(struct.shape[0])])
        return get(keys)

    structs = jax.eval_shape(jmodel.build(jcfg).init, jax.random.key(0))
    return jax.tree_util.tree_map_with_path(leaf, structs)


def test_sharded_decode_matches_reference_unsharded(float32_compute):
    """The port's sharded decode on (2, 4) against the JAX package's
    unsharded decode on the same weights (carried across by
    ``lm_params_from_reference``), float32: 1e-5 of max|logit|."""
    cfg = reduced("qwen3-1.7b")
    jcfg = dataclasses.replace(
        jconfigs.get_config("qwen3-1.7b"), n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=256, remat=False,
        use_scan=False)
    jp = reference_tree(jcfg, model.build(cfg).init(
        torch.Generator().manual_seed(7)))
    params = convert.lm_params_from_reference(
        cfg, jax.tree.map(np.asarray, jp), "cpu")
    mesh = make_mesh(2, 4, device="cpu")
    toks = serve_batch(cfg, 4, 6, seed=8)
    pairs, _, _ = run_serving(cfg, params, mesh, toks, 2, 8)
    jm = jmodel.build(jcfg)
    policy = jsharding.Policy.none()
    _, c = jax.jit(lambda p, tk: jm.prefill(policy, p, 8, tokens=tk))(
        jp, jnp.asarray(toks[:, :2].numpy()))
    step = jax.jit(lambda p, tk, c, pos: jm.decode_step(policy, p, tk, c, pos))
    for i in range(2, 6):
        want, c = step(jp, jnp.asarray(toks[:, i:i + 1].numpy()), c,
                       jnp.full((4,), i, jnp.int32))
        close(pairs[i - 1][0], np.asarray(want), TOL, f"step {i}")
