"""The port's encoder-decoder family (``repro_torch.models.whisper``,
``attention.cross_attend`` / ``encoder_kv``, the ``encdec`` branch of
``models.model`` and ``convert.lm_params_from_reference``) against the
reference package, on the CPU, at ``reduce_config(whisper-medium)`` width.

Inputs are seeded numpy; weights come from the reference's
``init(key(2), 64)`` with its constant leaves (LayerNorm scales and biases)
perturbed, and cross by ``convert.lm_params_from_reference``. Tolerances,
relative to the largest magnitude of the reference's output: 1e-5 in
float32 (every package's ``COMPUTE_DTYPE`` patched, float32 weights; the
packages sum in other orders) and 2e-2 in bf16 (XLA and PyTorch round bf16
at other places; a bf16 ulp at the logit scale is 0.4%). One train step
(``steps.make_train_step``, float32, ``peak_lr=0`` so that the first
moment holds the clipped gradients): loss and nll 1e-5, the gradients, the
second moment and the gradient norm 1e-4 of their largest magnitude.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import steps as jsteps  # noqa: E402
from repro.configs.base import ShapeSpec as JShapeSpec  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.models import whisper as jwhisper  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compression as jcompression  # noqa: E402
from repro.sharding import Policy  # noqa: E402

from repro_torch import configs, steps  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.models import attention, model, transformer, whisper  # noqa: E402

POLICY = Policy.none()
F32_TOL, BF16_TOL = 1e-5, 2e-2
ARCH = "whisper-medium"
MAX_POS = 64
B, S, CACHE_LEN, DECODE_STEPS = 2, 6, 12, 4
DTYPES = ("f32", "bf16")


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def f64(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().double().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32), np.float64)


def close(got, want, tol, what):
    """max |got - want| <= tol · max |want|."""
    got, want = f64(got), f64(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, f"{what}: max|diff| {err} > {tol} x {scale}"


def flat(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from flat(val, prefix + (key,))
        else:
            yield "/".join(prefix + (key,)), val


@pytest.fixture
def compute(request, monkeypatch):
    """'f32' patches both packages' compute dtypes to float32; 'bf16' keeps
    them. Returns the dtype name."""
    if request.param == "f32":
        for mod in (transformer, whisper, steps):
            monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)
        for mod in (jtransformer, jwhisper, jsteps):
            monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)
    return request.param


def cfgs(**changes):
    cfg = configs.reduce_config(configs.get_config(ARCH))
    jcfg = jconfigs.reduce_config(jconfigs.get_config(ARCH))
    return (dataclasses.replace(cfg, **changes),
            dataclasses.replace(jcfg, **changes))


@functools.lru_cache(maxsize=None)
def reference_params(vocab=None):
    _, jcfg = cfgs(**({} if vocab is None else {"vocab": vocab}))
    params = jax.tree.map(np.asarray,
                          jmodel.build(jcfg).init(jax.random.key(2), MAX_POS))
    rng = np.random.default_rng(11)

    def perturb(path, leaf):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return leaf + 0.1 * rng.normal(size=leaf.shape).astype(np.float32)
        if "bias" in name:
            return 0.1 * rng.normal(size=leaf.shape).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(perturb, params)


def both(dtype, vocab=None):
    """(port cfg, port params, reference cfg, reference params) in dtype."""
    cfg, jcfg = cfgs(**({} if vocab is None else {"vocab": vocab}))
    jp = reference_params(vocab)
    params = lm_params_from_reference(cfg, jp, "cpu")
    if dtype == "bf16":
        params = params.to(torch.bfloat16)
        jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), jp)
    return cfg, params, jcfg, jp


def inputs(cfg, dtype, seed=3, s=S):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)
    frames = (rng.normal(size=(B, cfg.enc_seq, cfg.d_model)) * 0.5).astype(
        np.float32)
    if dtype == "bf16":
        frames = np.array(jnp.asarray(frames, jnp.bfloat16).astype(jnp.float32))
    return tokens, frames


def tol_of(dtype):
    return F32_TOL if dtype == "f32" else BF16_TOL


# ---------------------------------------------------------------------------
# Pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compute", DTYPES, indirect=True)
def test_cross_attend_and_encoder_kv_match_reference(compute):
    cfg, params, _, jp = both(compute)
    dt = torch.float32 if compute == "f32" else torch.bfloat16
    jdt = jnp.float32 if compute == "f32" else jnp.bfloat16
    rng = np.random.default_rng(5)
    enc = rng.normal(size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    kw = dict(n_kv_heads=cfg.n_heads, head_dim=cfg.head_dim_)
    jx = jax.tree.map(lambda a: a[0], jp["layers"])["xattn"]
    k, v = attention.encoder_kv(params.layers[0].xattn, t(enc).to(dt), **kw)
    jk, jv = jattn.encoder_kv(jx, jnp.asarray(enc, jdt), **kw)
    assert k.shape == (B, cfg.enc_seq, cfg.n_heads, cfg.head_dim_)
    close(k, jk, tol_of(compute), "encoder_kv k")
    close(v, jv, tol_of(compute), "encoder_kv v")
    got = attention.cross_attend(params.layers[0].xattn, t(x).to(dt), (k, v),
                                 n_heads=cfg.n_heads, **kw)
    want = jattn.cross_attend(jx, jnp.asarray(x, jdt), (jk, jv),
                              n_heads=cfg.n_heads, policy=POLICY, **kw)
    assert got.dtype == dt
    close(got, want, tol_of(compute), "cross_attend")


@pytest.mark.parametrize("compute", DTYPES, indirect=True)
def test_encode_matches_reference(compute):
    cfg, params, jcfg, jp = both(compute)
    _, frames = inputs(cfg, compute)
    got = whisper.encode(cfg, params, t(frames))
    want = jax.jit(lambda p, f: jwhisper.encode(jcfg, POLICY, p, f))(
        jp, jnp.asarray(frames))
    assert got.dtype == whisper.COMPUTE_DTYPE
    close(got, want, tol_of(compute), "encode")


@pytest.mark.parametrize("compute", DTYPES, indirect=True)
def test_apply_train_matches_reference(compute):
    cfg, params, jcfg, jp = both(compute)
    tokens, frames = inputs(cfg, compute)
    logits, aux = whisper.apply_train(cfg, params, t(tokens), t(frames))
    want, jaux = jax.jit(lambda p, tk, f: jwhisper.apply_train(
        jcfg, POLICY, p, tk, f))(jp, jnp.asarray(tokens), jnp.asarray(frames))
    assert logits.dtype == torch.float32 and float(aux) == float(jaux) == 0.0
    close(logits, want, tol_of(compute), "apply_train logits")


@pytest.mark.parametrize("compute", DTYPES, indirect=True)
def test_prefill_and_decode_steps_match_reference(compute):
    """Prefill (logits and every cache tensor, shapes and dtypes), then
    DECODE_STEPS steps fed the reference's greedy tokens, each package
    decoding from its own cache; the cross K/V stay as prefill left them."""
    cfg, params, jcfg, jp = both(compute)
    m, jm = model.build(cfg), jmodel.build(jcfg)
    tol = tol_of(compute)
    tokens, frames = inputs(cfg, compute)
    logits, cache = m.prefill(params, CACHE_LEN, tokens=t(tokens),
                              frames=t(frames))
    jlogits, jcache = jax.jit(lambda p, tk, f: jm.prefill(
        POLICY, p, CACHE_LEN, tokens=tk, frames=f))(
        jp, jnp.asarray(tokens), jnp.asarray(frames))

    def check(what):
        got, want = dict(flat(cache)), dict(flat(jcache))
        assert sorted(got) == sorted(want)
        for key, w in want.items():
            assert str(got[key].dtype).split(".")[-1] == str(w.dtype), key
            assert tuple(got[key].shape) == w.shape, key
            if key.endswith("pos"):
                np.testing.assert_array_equal(got[key].numpy(), np.asarray(w))
            else:
                close(got[key].float(), w, tol, f"{what} {key}")

    close(logits, jlogits, tol, "prefill logits")
    check("prefill")
    cross = {k: v.clone() for k, v in cache["cross"].items()}
    step = jax.jit(lambda p, tok, c, pos: jm.decode_step(POLICY, p, tok, c, pos))
    tok = np.asarray(jnp.argmax(jlogits, -1))[:, None].astype(np.int32)
    for i in range(DECODE_STEPS):
        pos = np.full((B,), S + i, np.int32)
        logits, out = m.decode_step(params, t(tok), cache, t(pos))
        assert out is cache
        jlogits, jcache = step(jp, jnp.asarray(tok), jcache, jnp.asarray(pos))
        close(logits, jlogits, tol, f"decode {i}")
        tok = np.asarray(jnp.argmax(jlogits, -1))[:, None].astype(np.int32)
    check("after decode")
    for k, v in cache["cross"].items():
        assert torch.equal(v, cross[k]), k


@pytest.mark.parametrize("compute", ["f32"], indirect=True)
def test_decode_from_one_token_matches_prefill(compute):
    """The reference's consistency check, on the port alone: prefill of the
    first token (one encoder pass fills the cross K/V), then S - 1 decode
    steps, against the prefill of all S tokens."""
    cfg = configs.reduce_config(configs.get_config(ARCH))
    m = model.build(cfg)
    params = m.init(torch.Generator().manual_seed(4), MAX_POS)
    tokens, frames = inputs(cfg, compute, seed=6)
    full, _ = m.prefill(params, CACHE_LEN, tokens=t(tokens), frames=t(frames))
    logits, cache = m.prefill(params, CACHE_LEN, tokens=t(tokens[:, :1]),
                              frames=t(frames))
    for i in range(1, S):
        logits, cache = m.decode_step(params, t(tokens[:, i:i + 1]), cache,
                                      torch.full((B,), i, dtype=torch.int32))
    close(logits, full, 1e-4, "prefill(1) + decode vs prefill")
    want = np.full(CACHE_LEN, -1)
    want[:S] = np.arange(S)
    np.testing.assert_array_equal(
        cache["layers"]["pos"].numpy(),
        np.broadcast_to(want, cache["layers"]["pos"].shape))


@pytest.mark.parametrize("compute", ["f32"], indirect=True)
def test_train_step_matches_reference(compute):
    """One ``make_train_step`` step (M=2 microbatches, frames in the batch)
    against the reference's: loss, nll, grad_norm, the moments by
    parameter name, the parameters unchanged at lr 0."""
    cfg, params, jcfg, jp = both(compute)
    tokens, frames = inputs(cfg, compute, seed=8)
    batch = {"tokens": tokens, "frames": frames,
             "labels": np.roll(tokens, -1, axis=1)}
    kw = dict(microbatches=2, peak_lr=0.0, warmup_steps=0, total_steps=10)
    before = {n: p.detach().clone() for n, p in params.named_parameters()}
    state, metrics = steps.make_train_step(
        cfg, ShapeSpec("t", "train", S, B), **kw).fn(
        steps.init_train_state(params), {k: t(v) for k, v in batch.items()})
    jstep = jsteps.make_train_step(jcfg, JShapeSpec("t", "train", S, B), None,
                                   **kw)
    jstate, jmetrics = jax.jit(jstep.fn)(
        {"params": jp, "opt": jadamw.init(jp),
         "ef": jcompression.init_error_feedback(jp)},
        {k: jnp.asarray(v) for k, v in batch.items()})
    for key in ("loss", "nll"):
        close(metrics[key], jmetrics[key], F32_TOL, key)
    close(metrics["grad_norm"], jmetrics["grad_norm"], 1e-4, "grad_norm")
    for part in ("mu", "nu"):
        want = {n: p.detach() for n, p in lm_params_from_reference(
            cfg, jax.tree.map(np.asarray, getattr(jstate["opt"], part)),
            "cpu").named_parameters()}
        got = getattr(state["opt"], part)
        scale = max(float(w.abs().max()) for w in want.values())
        for n, w in want.items():
            err = float((got[n] - w).abs().max())
            assert err <= 1e-4 * scale, f"{part} {n}: {err} > 1e-4 x {scale}"
    for n, p in state["params"].named_parameters():
        assert torch.equal(p.detach(), before[n]), n


# ---------------------------------------------------------------------------
# Facade, caches, padding, conversion, sizes
# ---------------------------------------------------------------------------


def test_cache_specs_and_init_cache_match_reference():
    cfg, jcfg = configs.get_config(ARCH), jconfigs.get_config(ARCH)
    for shape in configs.LM_SHAPES:
        jshape = jconfigs.get_shape(shape.name)
        got = dict(flat(model.cache_specs(cfg, shape, batch_override=4)))
        want = dict(flat(jmodel.cache_specs(jcfg, jshape, batch_override=4)))
        assert sorted(got) == sorted(want)
        for key, w in want.items():
            assert got[key][0] == w.shape, key
            assert str(got[key][1]).split(".")[-1] == str(w.dtype), key
    assert got["cross/k"][0] == (24, 4, 1500, 16, 64)
    small, jsmall = cfgs()
    cache = model.build(small).init_cache(B, CACHE_LEN, device="cpu")
    jcache = jmodel.build(jsmall).init_cache(B, CACHE_LEN)
    for key, w in dict(flat(jcache)).items():
        g = dict(flat(cache))[key]
        assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[-1] == str(w.dtype)
        if key.endswith("pos"):
            assert bool((g == -1).all()), key       # empty slots
        else:
            assert not g.any(), key


@pytest.mark.parametrize("compute", DTYPES, indirect=True)
def test_pad_columns_are_masked(compute):
    """A vocab of 100 pads the table to 128 rows: columns 100..127 of every
    logit read exactly -2**30, as the reference's; the rest match it."""
    cfg, params, jcfg, jp = both(compute, vocab=100)
    assert params.embed.tokens.shape == (128, cfg.d_model)
    m, jm = model.build(cfg), jmodel.build(jcfg)
    tokens, frames = inputs(cfg, compute)
    logits, _ = m.apply_train(params, tokens=t(tokens), frames=t(frames))
    last, cache = m.prefill(params, CACHE_LEN, tokens=t(tokens), frames=t(frames))
    step, _ = m.decode_step(params, t(tokens[:, :1]), cache,
                            torch.full((B,), S, dtype=torch.int32))
    want, _ = jm.apply_train(POLICY, jp, tokens=jnp.asarray(tokens),
                             frames=jnp.asarray(frames))
    for got in (logits, last, step):
        assert got.shape[-1] == 128
        assert bool((got[..., 100:] == -2.0 ** 30).all())
        assert bool((got[..., :100] > -1e6).all())
    np.testing.assert_array_equal(np.asarray(want)[..., 100:],
                                  logits[..., 100:].detach().numpy())
    close(logits[..., :100], np.asarray(want)[..., :100], tol_of(compute),
          "unpadded logits")


def test_converter_fills_each_parameter_once():
    """Every reference leaf (stacked enc_layers / layers once per layer,
    pos_embed, the padded table) lands in exactly one port parameter, and
    none is left over; the table of positions sets max_dec_positions; a
    stray or a missing leaf raises."""
    cfg, _ = cfgs()
    jp = reference_params()
    params = lm_params_from_reference(cfg, jp, "cpu")
    assert isinstance(params, whisper.Whisper)
    assert params.pos_embed.shape == (MAX_POS, cfg.d_model)
    named = {name: p.detach().numpy() for name, p in params.named_parameters()}
    owner = {}
    for path, leaf in flat(jp):
        stacked = path.startswith(("layers/", "enc_layers/"))
        for a in (leaf if stacked else [leaf]):
            hits = [name for name, p in named.items()
                    if np.array_equal(p, a.T if name.endswith(".weight") else a)]
            assert len(hits) == 1, (path, hits)
            assert hits[0] not in owner, (path, owner.get(hits[0]))
            owner[hits[0]] = path
    assert set(owner) == set(named), sorted(set(named) - set(owner))
    assert sum(k.startswith("enc_layers.") for k in owner) == 10 * cfg.n_enc_layers
    stray = dict(jp, extra={"w": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="no port parameter"):
        lm_params_from_reference(cfg, stray, "cpu")
    for drop in ("enc_norm", "pos_embed"):
        with pytest.raises(ValueError, match="no reference leaf"):
            lm_params_from_reference(
                cfg, {k: v for k, v in jp.items() if k != drop}, "cpu")
    enc = dict(jp["enc_layers"])
    del enc["mlp"]
    with pytest.raises(ValueError, match="no reference leaf"):
        lm_params_from_reference(cfg, dict(jp, enc_layers=enc), "cpu")


def test_whisper_medium_sizes_equal_reference():
    """At full width (built on the meta device, nothing allocated): the
    reference's eval_shape parameter count, split as encoder, decoder,
    padded table and positions."""
    cfg, jcfg = configs.get_config(ARCH), jconfigs.get_config(ARCH)
    params = whisper.Whisper(cfg, torch.device("meta"))
    want = jax.eval_shape(lambda: jmodel.build(jcfg).init(jax.random.key(0)))
    n = sum(p.numel() for p in params.parameters())
    assert n == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(want))
    assert n == 762_302_464
    count = {part: sum(p.numel() for name, p in params.named_parameters()
                       if name.startswith(part + "."))
             for part in ("enc_layers", "layers", "embed")}
    assert count["embed"] == 51968 * 1024
    assert params.pos_embed.numel() == 4096 * 1024
    assert count["enc_layers"] == 24 * (4 * 1024 ** 2 + 2 * 1024 * 4096 + 4 * 1024)
    assert count["layers"] == 24 * (8 * 1024 ** 2 + 2 * 1024 * 4096 + 6 * 1024)


def test_build_encdec_facade():
    cfg = configs.reduce_config(configs.get_config(ARCH))
    m = model.build(cfg)
    params = m.init(torch.Generator().manual_seed(0))
    assert isinstance(params, whisper.Whisper)
    assert params.pos_embed.shape == (4096, cfg.d_model)
    assert m.init(torch.Generator().manual_seed(0), 16).pos_embed.shape[0] == 16
    with pytest.raises(ValueError, match="not a decoder-only family"):
        transformer.LM(cfg)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            m.init_cache(1, 8)
