"""The sharded RWKV-6 (``ssm``), Griffin/hybrid (``hybrid``) and whisper
(``encdec``) paths of the port on the CPU: the ``*_sharded`` functions of
``models/{rwkv6,griffin,transformer,whisper}.py`` through
``steps.make_*_step(cfg, shape, mesh)`` and the ``Model`` facade, and
``sharding.all_to_all``.

Meshes are single-controller ``make_mesh(..., device="cpu")`` grids: no
subprocess and no forced JAX device count. Widths are ``reduce_config``'s
(d 64, 4 heads; rwkv6 4 heads of 16, hybrid 5 layers = one (rec, rec,
attn) group and a 2-block tail with ``local_window`` 8, whisper 2 + 2
layers over 8 frames).

Tolerances: float32 sharded against unsharded 1e-5 of the largest
magnitude (only reduction order differs: the row-parallel partial sums,
the flash-decode combine, the channel mix's reduce-scatter); positions
exact; ``all_to_all`` exact. The train step runs at ``peak_lr=0``, so the
parameters must come back unchanged and the first and second moments
carry the clipped gradients (1e-5 of the largest). Against the JAX
package's unsharded prefill and decode, 1e-5 float32.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch import configs, convert, steps
from repro_torch import sharding as S
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.mesh import axis_index, axis_size, make_mesh
from repro_torch.models import model, transformer, whisper

TOL = 1e-5
ARCHS = ("rwkv6-3b", "recurrentgemma-9b", "whisper-medium")
MESHES = ((1, 2), (2, 2), (1, 4), (2, 4))
B = 4
CONSTANT_AT_INIT = ("mu_x", "mu", "mu_k", "mu_r", "w0", "b_a", "b_i", "conv_b")


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
    for mod in (transformer, whisper, steps):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)


def reduced(arch, **changes):
    return dataclasses.replace(configs.reduce_config(configs.get_config(arch)),
                               **changes)


@functools.lru_cache(maxsize=None)
def weights(arch, **changes):
    """Float32 parameters of the reduced config, from a seeded generator,
    with the leaves that start constant (norms, RWKV-6's mixes and ``w0``,
    Griffin's gate and conv biases) perturbed so that their layouts are
    exercised. Cached: callers must not modify them."""
    params = model.build(reduced(arch, **changes)).init(
        torch.Generator().manual_seed(2))
    rng = np.random.default_rng(11)
    with torch.no_grad():
        for name, p in params.named_parameters():
            last = name.split(".")[-1]
            if "scale" in name or last in CONSTANT_AT_INIT or last == "bias":
                p += torch.from_numpy(0.1 * rng.normal(size=p.shape).astype(
                    np.float32))
    return params


def inputs(cfg, b, t, seed=0):
    """(tokens (b, t) int32, frames (b, enc_seq, d) or None) from seeded
    numpy."""
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, t)).astype(np.int32))
    frames = None
    if cfg.family == "encdec":
        frames = torch.from_numpy((rng.normal(size=(b, cfg.enc_seq, cfg.d_model))
                                   * 0.5).astype(np.float32))
    return toks, frames


def run_serving(cfg, params, mesh, toks, frames, prompt, cache_len):
    """Sharded prefill of ``prompt`` tokens then decode of the rest through
    ``make_*_step(cfg, shape, mesh)``, beside the unsharded port; returns
    [(sharded logits, unsharded logits)], the gathered sharded cache and
    the unsharded cache."""
    b, t = toks.shape
    m = model.build(cfg)
    pstep = steps.make_prefill_step(cfg, ShapeSpec("p", "prefill", cache_len, b),
                                    mesh)
    dstep = steps.make_decode_step(cfg, ShapeSpec("d", "decode", cache_len, b),
                                   mesh)
    sp = convert.shard_lm(params, mesh)
    batch = {"tokens": toks[:, :prompt]}
    if frames is not None:
        batch["frames"] = frames
    lg, cache = pstep.fn(sp, S.shard_tree(batch, pstep.in_specs[1], mesh))
    want, rcache = m.prefill(params, cache_len, **batch)
    out = [(S.gather(lg, pstep.out_specs[0], mesh), want)]
    for i in range(prompt, t):
        p_b = torch.full((b,), i, dtype=torch.int32)
        p_b[1] += 1                               # rows at different slots
        lg, cache = dstep.fn(sp, cache, S.shard(toks[:, i:i + 1],
                                                dstep.in_specs[2], mesh),
                             S.shard(p_b, dstep.in_specs[3], mesh))
        want, rcache = m.decode_step(params, toks[:, i:i + 1], rcache, p_b)
        out.append((S.gather(lg, dstep.out_specs[0], mesh), want))
    return out, S.gather_tree(cache, dstep.out_specs[1], mesh), rcache


def leaves(tree, path=""):
    """(path, leaf) of every leaf of a cache tree (dicts and lists; a
    ``PerRank``, a spec or a ``(shape, dtype)`` struct is a leaf)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{path}/{k}")
    elif isinstance(tree, list) and not isinstance(tree, S.PerRank):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def check_caches(got, want, what):
    """Every leaf of the gathered cache against the unsharded one: the
    positions exact, the rest 1e-5 of its largest magnitude."""
    got_leaves = dict(leaves(got))
    want_leaves = dict(leaves(want))
    assert got_leaves.keys() == want_leaves.keys()
    for path, w in want_leaves.items():
        g = got_leaves[path]
        assert g.dtype == w.dtype, path
        if path.endswith("/pos"):
            assert torch.equal(g, w), f"{what} {path}"
        else:
            close(g, w, TOL, f"{what} {path}")


# ---------------------------------------------------------------------------
# all_to_all
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,axis,dims", [
    ((1, 4), "model", (1, 3)), ((2, 4), "model", (3, 1)),
    ((2, 2), "data", (0, 2)), ((2, 4), ("data", "model"), (2, 1))])
def test_all_to_all_equals_all_gather_then_slice(shape, axis, dims):
    """Moving a split from ``concat_dim`` to ``split_dim`` by ``all_to_all``
    equals gathering ``concat_dim`` and keeping the rank's chunk of
    ``split_dim``: exact, one call under its own kind, every rank's input
    bytes counted once."""
    split_dim, concat_dim = dims
    mesh = make_mesh(*shape, device="cpu")
    full = torch.from_numpy(np.random.default_rng(0).normal(
        size=(8, 8, 8, 8)).astype(np.float32))
    src = [None] * 4
    src[concat_dim] = axis
    xs = S.shard(full, S.P(*src), mesh)
    mesh.collectives.reset()
    got = S.all_to_all(xs, mesh, axis, split_dim, concat_dim)
    key = "all_to_all/" + "+".join((axis,) if isinstance(axis, str) else axis)
    assert mesh.collectives.calls == {key: 1}
    assert mesh.collectives.bytes[key] == sum(x.numel() * 4 for x in xs)
    want = S.all_gather(xs, mesh, axis, concat_dim)
    dst = [None] * 4
    dst[split_dim] = axis
    for r, (g, w) in enumerate(zip(got, S.shard(full, S.P(*dst), mesh))):
        assert torch.equal(g, w), r
        assert torch.equal(g, want[r].chunk(axis_size(mesh, axis), split_dim)[
            axis_index(mesh, r, axis)]), r


# ---------------------------------------------------------------------------
# The steps on a mesh against the unsharded port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_every_family_steps_under_a_mesh(arch):
    """``make_prefill_step(..., mesh).fn`` and the facade's ``decode_step``
    under a policy run every family (none raises): finite logits of the
    (padded) vocabulary on every rank, in bf16."""
    cfg = reduced(arch)
    mesh = make_mesh(1, 2, device="cpu")
    params = convert.shard_lm(model.build(cfg).init(
        torch.Generator().manual_seed(0)).to(torch.bfloat16), mesh)
    toks, frames = inputs(cfg, 2, 4)
    step = steps.make_prefill_step(cfg, ShapeSpec("p", "prefill", 8, 2), mesh)
    batch = {"tokens": toks}
    if frames is not None:
        batch["frames"] = frames
    lg, cache = step.fn(params, S.shard_tree(batch, step.in_specs[1], mesh))
    vocab = whisper._padded_vocab(cfg) if arch == "whisper-medium" else cfg.vocab
    lg, _ = model.build(cfg).decode_step(
        params, S.shard(toks[:, :1], S.P(), mesh), cache,
        S.shard(torch.full((2,), 4, dtype=torch.int32), S.P(), mesh),
        policy=S.Policy.for_mesh(mesh))
    for x in lg:
        assert x.shape == (2, vocab) and bool(torch.isfinite(x).all())


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode_match_unsharded(arch, shape,
                                                    float32_compute):
    """Prefill of 4 tokens and 4 decode steps, float32: every logit row
    1e-5 of max|logit|; every cache leaf gathered by ``gather_tree`` (RWKV-6's
    ``wkv`` and shifts, Griffin's ``conv`` / ``h`` and the tail, whisper's
    self and cross K/V) 1e-5 of its max, positions exact."""
    cfg = reduced(arch)
    toks, frames = inputs(cfg, B, 8)
    pairs, cache, rcache = run_serving(cfg, weights(arch),
                                       make_mesh(*shape, device="cpu"),
                                       toks, frames, 4, 16)
    for i, (got, want) in enumerate(pairs):
        close(got, want, TOL, f"{arch} {shape} step {i}")
    check_caches(cache, rcache, f"{arch} {shape}")


@pytest.mark.parametrize("shape,prompt", [((1, 4), 6), ((2, 2), 10)])
def test_hybrid_decodes_past_its_window(shape, prompt, float32_compute):
    """The reduced hybrid (window 8, so an 8-slot rolling cache, 8/|model|
    slots per rank) decoded to position 15: from a 6-token prompt the
    slot wraps during decode, from a 10-token prompt already in prefill;
    either way the write of each step lands on the rank that owns slot
    ``pos % 8`` and the wrap crosses shards. Logits and every cache leaf
    as in the test above."""
    arch = "recurrentgemma-9b"
    cfg = reduced(arch)
    assert cfg.local_window == 8
    toks, _ = inputs(cfg, B, 16, seed=3)
    pairs, cache, rcache = run_serving(cfg, weights(arch),
                                       make_mesh(*shape, device="cpu"), toks,
                                       None, prompt, 16)
    assert rcache["layers"]["b2_attn_mlp"]["k"].shape[3] == 8
    for i, (got, want) in enumerate(pairs):
        close(got, want, TOL, f"step {i}")
    check_caches(cache, rcache, f"hybrid {shape}")


def train_batch(cfg, b, t, seed=5):
    toks, frames = inputs(cfg, b, t, seed)
    rng = np.random.default_rng(seed + 1)
    batch = {"tokens": toks, "labels": torch.from_numpy(
        rng.integers(0, cfg.vocab, (b, t)).astype(np.int32))}
    if frames is not None:
        batch["frames"] = frames
    return batch


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_unsharded(arch, shape, float32_compute):
    """One step, M=2, remat on, float32, ``peak_lr=0``: loss, NLL and grad
    norm 1e-5 relative; the first and second moments (the clipped
    gradients and their squares) 1e-5 of their largest magnitude; the
    parameters unchanged; the step counted on every rank."""
    cfg = reduced(arch, remat=True)
    b, t = 8, 8
    batch = train_batch(cfg, b, t)
    kw = dict(microbatches=2, compress="none", peak_lr=0.0, warmup_steps=0,
              total_steps=10)
    shape_ = ShapeSpec("t", "train", t, b)

    def state():
        return steps.init_train_state(model.build(cfg).init(
            torch.Generator().manual_seed(0)))

    want_state, want = steps.make_train_step(cfg, shape_, **kw).fn(
        state(), dict(batch))
    mesh = make_mesh(*shape, device="cpu")
    tstep = steps.make_train_step(cfg, shape_, mesh, **kw)
    sharded, got = tstep.fn(convert.shard_train_state(state(), mesh),
                            S.shard_tree(batch, tstep.in_specs[1], mesh))
    for key in ("loss", "nll", "grad_norm"):
        close(got[key], want[key], TOL, key)
    whole = convert.gather_train_state(sharded)
    for part in ("mu", "nu"):
        ref = getattr(want_state["opt"], part)
        top = max(float(t.abs().max()) for t in ref.values())
        for n, t in ref.items():
            diff = float((getattr(whole["opt"], part)[n] - t).abs().max())
            assert diff <= TOL * top, (part, n)
    ref_params = dict(want_state["params"].named_parameters())
    for n, p in whole["params"].named_parameters():
        assert torch.equal(p, ref_params[n]), n
    assert [int(s) for s in sharded["opt"].step] == [1] * mesh.size


# ---------------------------------------------------------------------------
# Layouts, whisper's edges, collective counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_sharded_shapes_follow_the_cache_specs(arch):
    """Every leaf of the sharded empty cache (the tail and whisper's cross
    K/V included) has on every rank the shape ``local_shape`` gives for the
    decode step's ``out_specs`` and the unsharded cache's dtype; positions
    start at -1 and the rest at 0."""
    cfg = reduced(arch)
    mesh = make_mesh(2, 4, device="cpu")
    shape = ShapeSpec("d", "decode", 16, B)
    dstep = steps.make_decode_step(cfg, shape, mesh)
    policy = S.Policy.for_mesh(mesh)
    if cfg.family == "encdec":
        cache = whisper.init_dec_cache_sharded(cfg, policy, B, 16, cfg.enc_seq)
    else:
        cache = transformer.init_cache_sharded(cfg, policy, B, 16)
    specs = dict(leaves(dstep.out_specs[1]))
    structs = dict(leaves(model.cache_specs(cfg, shape)))
    got = dict(leaves(cache))
    assert got.keys() == structs.keys() == specs.keys()
    for path, xs in got.items():
        (full, dtype), spec = structs[path], specs[path]
        assert len(xs) == mesh.size
        for x in xs:
            assert tuple(x.shape) == S.local_shape(full, spec, mesh), path
            assert x.dtype == dtype, path
            assert bool((x == (-1 if path.endswith("/pos") else 0)).all()), path


def test_whisper_pad_columns_masked_on_the_last_rank_only(float32_compute):
    """vocab 120, padded to 128, over ``model`` = 4 (32 columns per rank):
    the vocab-split training logits hold -2**30 in the last rank's columns
    24–31 only; the gathered prefill and decode logits equal the unsharded
    port's (pad columns included) and no argmax is a pad column."""
    arch = "whisper-medium"
    cfg = reduced(arch, vocab=120)
    assert whisper._padded_vocab(cfg) == 128
    params = weights(arch, vocab=120)
    mesh = make_mesh(1, 4, device="cpu")
    toks, frames = inputs(cfg, B, 8, seed=4)
    policy = S.Policy.for_mesh(mesh)
    with torch.no_grad():
        logits, _ = model.build(cfg).apply_train(
            convert.shard_lm(params, mesh), tokens=S.shard(toks, S.P(), mesh),
            frames=S.shard(frames, S.P(), mesh), policy=policy)
    pad = float(-2.0 ** 30)
    for r, lg in enumerate(logits):
        assert lg.shape[-1] == 32
        masked = (lg == pad).all(dim=(0, 1))
        assert masked.tolist() == [r == 3 and c >= 24 for c in range(32)], r
    pairs, _, _ = run_serving(cfg, params, mesh, toks, frames, 4, 16)
    for got, want in pairs:
        close(got, want, TOL, "padded logits")
        assert bool((got[:, 120:] == pad).all())
        assert int(got.argmax(-1).max()) < 120


def test_whisper_indivisible_frames_keep_the_residual_whole(float32_compute):
    """6 frames over ``model`` = 4 (as 1500 frames over 8): the encoder's
    residual stays whole (no sequence split), and the encoder states and
    the prefill and decode logits equal the unsharded port's."""
    arch = "whisper-medium"
    cfg = reduced(arch, enc_seq=6)
    mesh = make_mesh(2, 4, device="cpu")
    policy = S.Policy.for_mesh(mesh)
    assert not policy.sequence_split(6) and policy.sequence_split(8)
    params = weights(arch, enc_seq=6)
    toks, frames = inputs(cfg, B, 8, seed=6)
    with torch.no_grad():
        enc = whisper.encode_sharded(cfg, policy, convert.shard_lm(params, mesh),
                                     S.shard(frames, S.P("data"), mesh))
        want = whisper.encode(cfg, params, frames)
    close(S.gather(enc, S.P("data"), mesh), want, TOL, "encoder states")
    pairs, cache, rcache = run_serving(cfg, params, mesh, toks, frames, 4, 16)
    for i, (got, want) in enumerate(pairs):
        close(got, want, TOL, f"step {i}")
    check_caches(cache, rcache, "whisper enc_seq 6")


def expected_decode_collectives(cfg, data: int, m: int) -> dict:
    """Collective calls of one weight-stationary decode step on a (data, m)
    mesh, m > 1 (the batch on ``data``).

    Over ``data``, activations only: each RMSNorm's psum of the sum of
    squares (a LayerNorm's two: the sum, the centred squares), the MLP's
    gate/up psum, a reduce-scatter of each block's column products (q/k/v,
    Griffin's w_y/w_x, whisper's cross q) into the batch rows and an
    all_gather of the rows before each row-parallel product (wo, Griffin's
    w_o, the cross wo); the tokens' all_gather (whisper's positions too),
    the final norm and the logits' reduce-scatter. RWKV-6 keeps its eight
    weight gathers and moves the residual by two all_to_alls; Griffin
    gathers its two gate matrices. Over ``model``: the lookup's psum and
    the vocab all_gather; per flash-decode attention one all_gather of
    q/k/v, a pmax and two psums, plus ``wo`` and the MLP's psums; per
    Griffin block the gate input's all_gather and two psums (``w_o``,
    MLP); per RWKV-6 block the two shift all_gathers, two wkv all_to_alls,
    the ``w_o`` psum, the channel mix's psum_scatter and all_gather;
    whisper adds the cross-attention's psum."""
    _, kinds, n_groups, tail = transformer._plan(cfg) if cfg.family != "encdec" \
        else ((), ("dec",), cfg.n_layers, ())
    blocks = list(kinds) * n_groups + list(tail)
    norm = 2 if cfg.norm == "layernorm" else 1
    per = {"rwkv": {"all_gather/data": 8, "all_to_all/data": 2,
                    "all_gather/model": 3, "all_to_all/model": 2,
                    "psum/model": 1, "psum_scatter/model": 1},
           "rec_mlp": {"all_gather/data": 3, "psum/data": 2 * norm + 1,
                       "psum_scatter/data": 1, "all_gather/model": 1,
                       "psum/model": 2},
           "attn_mlp": {"all_gather/data": 1, "psum/data": 2 * norm + 1,
                        "psum_scatter/data": 1, "all_gather/model": 1,
                        "pmax/model": 1, "psum/model": 4},
           "dec": {"all_gather/data": 2, "psum/data": 3 * norm + 1,
                   "psum_scatter/data": 2, "all_gather/model": 1,
                   "pmax/model": 1, "psum/model": 5}}
    out = {"all_gather/data": 1 + (cfg.family == "encdec"), "psum/data": norm,
           "psum_scatter/data": 1, "psum/model": 1, "all_gather/model": 1}
    for kind in blocks:
        for k, n in per[kind].items():
            out[k] = out.get(k, 0) + n
    if data == 1:
        out = {k: n for k, n in out.items() if not k.endswith("/data")}
    return out


@pytest.mark.parametrize("shape", [(2, 4), (1, 2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_collectives_follow_the_formula(arch, shape):
    """One decode step's calls by kind equal
    ``expected_decode_collectives`` (no other collective runs)."""
    cfg = reduced(arch)
    mesh = make_mesh(*shape, device="cpu")
    toks, frames = inputs(cfg, B, 5)
    params = convert.shard_lm(weights(arch), mesh)
    pstep = steps.make_prefill_step(cfg, ShapeSpec("p", "prefill", 8, B), mesh)
    dstep = steps.make_decode_step(cfg, ShapeSpec("d", "decode", 8, B), mesh)
    batch = {"tokens": toks[:, :4]}
    if frames is not None:
        batch["frames"] = frames
    _, cache = pstep.fn(params, S.shard_tree(batch, pstep.in_specs[1], mesh))
    mesh.collectives.reset()
    dstep.fn(params, cache, S.shard(toks[:, 4:], dstep.in_specs[2], mesh),
             S.shard(torch.full((B,), 4, dtype=torch.int32), dstep.in_specs[3],
                     mesh))
    assert dict(mesh.collectives.calls) == expected_decode_collectives(
        cfg, *shape)


# ---------------------------------------------------------------------------
# Against the JAX package's unsharded steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_steps_match_reference_unsharded(arch, float32_compute,
                                                 monkeypatch):
    """The port's sharded prefill (4 tokens) and 3 decode steps on (2, 2)
    against the JAX package's unsharded ``prefill`` / ``decode_step``
    (``Policy.none()``, jit on the CPU) on the same weights, carried across
    by ``convert.lm_params_from_reference``: 1e-5 of max|logit|."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro import sharding as jsharding
    from repro.models import model as jmodel
    from repro.models import transformer as jtransformer
    from repro.models import whisper as jwhisper

    for mod in (jtransformer, jwhisper, jmodel):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)
    cfg = reduced(arch)
    jcfg = dataclasses.replace(jconfigs.reduce_config(jconfigs.get_config(arch)),
                               use_scan=False)
    named = {n: p.detach().numpy() for n, p in weights(arch).named_parameters()}

    def leaf(path, struct):
        keys = tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)

        def get(p):
            name, transpose = convert._lm_target(p, set(named))
            return named[name].T if transpose else named[name]

        if keys[0] in ("layers", "enc_layers"):
            out = np.stack([get((keys[0], str(j)) + keys[1:])
                            for j in range(struct.shape[0])])
        else:
            out = get(keys)
        assert out.shape == struct.shape, keys
        return out

    jm = jmodel.build(jcfg)
    jp = jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(jm.init, jax.random.key(0)))
    params = convert.lm_params_from_reference(cfg, jax.tree.map(np.asarray, jp),
                                              "cpu")
    toks, frames = inputs(cfg, B, 7, seed=8)
    pairs, _, _ = run_serving(cfg, params, make_mesh(2, 2, device="cpu"), toks,
                              frames, 4, 8)
    policy = jsharding.Policy.none()
    extra = {} if frames is None else {"frames": jnp.asarray(frames.numpy())}
    want, c = jax.jit(lambda p, tk, ex: jm.prefill(policy, p, 8, tokens=tk, **ex))(
        jp, jnp.asarray(toks[:, :4].numpy()), extra)
    close(pairs[0][0], np.asarray(want), TOL, "prefill")
    step = jax.jit(lambda p, tk, c, pos: jm.decode_step(policy, p, tk, c, pos))
    for i in range(4, 7):
        pos = np.full((B,), i, np.int32)
        pos[1] += 1
        want, c = step(jp, jnp.asarray(toks[:, i:i + 1].numpy()), c,
                       jnp.asarray(pos))
        close(pairs[i - 3][0], np.asarray(want), TOL, f"step {i}")
