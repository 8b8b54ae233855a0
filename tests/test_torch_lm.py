"""The port's LM serving path (``repro_torch.configs``, ``repro_torch.models``,
``repro_torch.launch.serve``) against the reference package, on the CPU:
the dense, vlm, moe (mixtral-8x7b, qwen2-moe-a2.7b), ssm (rwkv6-3b), hybrid
(recurrentgemma-9b) and encdec (whisper-medium, with ``frames``) families
at ``reduce_config`` width, every cache tensor compared in shape and dtype;
the modules of the moe, ssm and hybrid families are tested one by one in
``tests/test_torch_lm_families.py``, whisper's in
``tests/test_torch_whisper.py``.

Inputs and the perturbations of the reference's constant leaves come from
seeded numpy; weights come from the reference's ``model.init(key(2))`` and
cross by ``convert.lm_params_from_reference``. Tolerances, each relative to
the largest magnitude of the reference's output (``max|ref|``):

* float32 (both packages' ``COMPUTE_DTYPE`` patched to float32, float32
  weights): ``F32_TOL`` = 1e-5. The packages sum in other orders; the
  observed gap is under 5e-7.
* bf16 (weights cast to bf16 in both, as the serve CLIs do): ``BF16_TOL`` =
  2e-2. XLA and PyTorch round bf16 at other places (XLA keeps fused
  elementwise chains in float32); the observed gap is 0.3–1.0%, a bf16
  ulp at the logit scale is 0.4%.
* Greedy tokens must be equal wherever the reference's top-2 margin
  exceeds twice the bf16 tolerance.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.models import whisper as jwhisper  # noqa: E402
from repro.sharding import Policy  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import (  # noqa: E402
    attention, common, mlp, model, transformer, whisper)

POLICY = Policy.none()
F32_TOL = 1e-5
BF16_TOL = 2e-2
SERVED = ("qwen3-1.7b", "granite-8b", "minitron-4b", "qwen2-72b",
          "llava-next-mistral-7b", "mixtral-8x7b", "qwen2-moe-a2.7b",
          "rwkv6-3b", "recurrentgemma-9b", "whisper-medium")
# leaves the reference initialises to a constant (zeros, or a linspace the
# same in every layer): perturbed, like the norm scales and biases, so the
# tests see them and each lands in exactly one port parameter
CONSTANT_AT_INIT = ("mu_x", "mu", "mu_k", "mu_r", "w0", "b_a", "b_i", "conv_b")
B, S, CACHE_LEN, DECODE_STEPS = 2, 8, 16, 4


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def flat(tree, prefix=()):
    """(path, leaf) for every leaf of nested dicts and lists (a cache of
    either package, or ``cache_specs``), list indices as strings."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, val in items:
        if isinstance(val, (dict, list)):
            yield from flat(val, prefix + (str(key),))
        else:
            yield prefix + (str(key),), val


def f64(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().double().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32), np.float64)


def close(got, want, tol, what):
    """max |got - want| <= tol · max |want| (both as float64 numpy)."""
    got, want = f64(got), f64(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: max|diff| {err} > {tol} x {scale}"


def greedy_equal(got_logits, want_logits, tol, what) -> int:
    """argmax equal in every row whose top-2 margin exceeds 2·tol·max|want|;
    returns how many rows that was."""
    got, want = f64(got_logits), f64(want_logits)
    top2 = np.sort(want, axis=-1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) > 2 * tol * np.abs(want).max()
    np.testing.assert_array_equal(got.argmax(-1)[sure], want.argmax(-1)[sure],
                                  err_msg=what)
    return int(sure.sum())


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_config_equals_reference(arch):
    ours, ref = configs.get_config(arch), jconfigs.get_config(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert (dataclasses.asdict(configs.reduce_config(ours))
            == dataclasses.asdict(jconfigs.reduce_config(ref)))
    assert ([dataclasses.asdict(s) for s in configs.shapes_for(ours)]
            == [dataclasses.asdict(s) for s in jconfigs.shapes_for(ref)])
    for c, r in ((ours, ref), (configs.reduce_config(ours),
                               jconfigs.reduce_config(ref))):
        assert c.param_count() == r.param_count()
        assert c.active_param_count() == r.active_param_count()
        assert c.supports_long_context() == r.supports_long_context()
        assert c.has_decoder() == r.has_decoder()
        assert (c.head_dim_, c.rwkv_heads) == (r.head_dim_, r.rwkv_heads)


def test_registry_tables_equal_reference():
    assert configs.ARCHS == jconfigs.ARCHS
    assert ([dataclasses.asdict(s) for s in configs.LM_SHAPES]
            == [dataclasses.asdict(s) for s in jconfigs.LM_SHAPES])
    for s in configs.LM_SHAPES:
        assert (dataclasses.asdict(configs.get_shape(s.name))
                == dataclasses.asdict(jconfigs.get_shape(s.name)))
        assert s.tokens == jconfigs.get_shape(s.name).tokens
    assert configs.SKIPPED_CELLS == jconfigs.SKIPPED_CELLS
    assert configs.get_config("qwen3-1.7b").param_count() == 1_720_451_072
    with pytest.raises(KeyError):
        configs.get_config("gpt-2")


def test_tm_configs_still_import():
    from repro_torch.configs.tm import PAPER_TM_CONFIGS
    assert PAPER_TM_CONFIGS["tm_mnist"].tm.n_clauses == 2000


# ---------------------------------------------------------------------------
# Module-level functions, float32
# ---------------------------------------------------------------------------


def test_norms_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32) * 3 + 1
    scale = rng.normal(size=16).astype(np.float32)
    bias = rng.normal(size=16).astype(np.float32)
    rms = common.RMSNorm(16)
    rms.scale.data = t(scale)
    ln = common.LayerNorm(16)
    ln.scale.data, ln.bias.data = t(scale), t(bias)
    for eps in (1e-5, 1e-6):
        close(common.rmsnorm(rms, t(x), eps),
              jcommon.rmsnorm({"scale": scale}, x, eps), F32_TOL, "rmsnorm")
        close(common.layernorm(ln, t(x), eps),
              jcommon.layernorm({"scale": scale, "bias": bias}, x, eps),
              F32_TOL, "layernorm")
    got = common.rmsnorm(rms, t(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_reference(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 6, 3, 16)).astype(np.float32)
    pos1 = np.arange(6) + 3
    pos2 = rng.integers(0, 40000, (2, 6))
    close(common.rope_freqs(16, theta), jcommon.rope_freqs(16, theta),
          F32_TOL, "rope_freqs")
    for pos in (pos1, pos2):
        close(common.apply_rope(t(x), t(pos), theta),
              jcommon.apply_rope(x, jnp.asarray(pos), theta), F32_TOL,
              "apply_rope")


def test_sinusoid_embed_activations_match_reference():
    close(common.sinusoidal_positions(12, 8),
          jcommon.sinusoidal_positions(12, 8), F32_TOL, "sinusoidal")
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 9)).astype(np.float32) * 3
    for name in ("silu", "gelu", "relu2"):
        close(common.activation(name)(t(x)), jcommon.activation(name)(x),
              F32_TOL, name)
    table = rng.normal(size=(11, 6)).astype(np.float32)
    head = rng.normal(size=(6, 11)).astype(np.float32)
    toks = rng.integers(0, 11, (2, 5))
    emb = common.Embed(11, 6)
    emb.tokens.data = t(table)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = common.embed(emb, t(toks), dt)
        want = jcommon.embed({"tokens": table}, jnp.asarray(toks), jdt)
        assert got.dtype == dt
        np.testing.assert_array_equal(f64(got), f64(want))
    h = rng.normal(size=(2, 5, 6)).astype(np.float32)
    lin = common.empty_linear(6, 11)
    lin.weight.data = t(head.T)
    close(common.unembed(emb, None, t(h)),
          jcommon.unembed({"tokens": table}, None, h), F32_TOL, "tied")
    close(common.unembed(emb, lin, t(h)),
          jcommon.unembed({"tokens": table}, head, h), F32_TOL, "lm_head")


def test_initializers_draw_from_the_generator():
    """The reference's distributions, drawn from the caller's generator:
    the same seed gives the same weights, another seed others."""
    w = common.dense_init(torch.Generator().manual_seed(0), 256, 64)
    assert w.shape == (256, 64) and w.dtype == torch.float32
    assert float(w.abs().max()) <= 2 * 256 ** -0.5
    assert abs(float(w.std()) * 256 ** 0.5 - 0.88) < 0.02  # truncated at ±2σ
    assert torch.equal(w, common.dense_init(torch.Generator().manual_seed(0),
                                            256, 64))
    cfg = configs.reduce_config(configs.get_config("qwen2-72b"))
    a, b, c = (transformer.init_params(torch.Generator().manual_seed(s), cfg)
               for s in (1, 1, 2))
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        pa = pa.detach()
        assert torch.equal(pa, pb), name
        if name.endswith(("scale", "bias")):   # ones and zeros, as the reference
            want = 1.0 if name.endswith("scale") else 0.0
            assert bool((pa == want).all()), name
        else:
            assert not torch.equal(pa, pc), name
            bound = 2.0 if "embed" in name else 2 * pa.shape[-1] ** -0.5
            assert float(pa.abs().max()) <= bound, name


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", False),
                                       ("relu2", False)])
def test_mlp_matches_reference(act, gated):
    rng = np.random.default_rng(3)
    jp = jmlp.init_mlp(jax.random.key(0), 16, 24, gated=gated)
    jp = jax.tree.map(np.asarray, jp)
    p = mlp.MLP(16, 24, gated=gated)
    p.w_up.weight.data = t(jp["w_up"].T)
    p.w_down.weight.data = t(jp["w_down"].T)
    if gated:
        p.w_gate.weight.data = t(jp["w_gate"].T)
    x = rng.normal(size=(2, 3, 16)).astype(np.float32)
    close(mlp.mlp(p, t(x), act=act),
          jmlp.mlp(jp, x, act=act, policy=POLICY), F32_TOL, act)


def test_mask_matches_reference():
    rng = np.random.default_rng(4)
    q_pos = rng.integers(0, 12, (2, 7))
    k_pos = np.where(rng.uniform(size=(2, 9)) < 0.2, -1,
                     rng.integers(0, 12, (2, 9)))
    for kind, window in (("causal", None), ("causal", 3), ("full", None)):
        np.testing.assert_array_equal(
            attention._mask(t(q_pos), t(k_pos), kind, window).numpy(),
            np.asarray(jattn._mask(jnp.asarray(q_pos), jnp.asarray(k_pos),
                                   kind, window)), err_msg=f"{kind} {window}")
    with pytest.raises(ValueError):
        attention._mask(t(q_pos), t(k_pos), "bidirectional", None)


def attn_pair(seed, d=32, h=4, hkv=2, dh=8, qkv_bias=True, qk_norm=True):
    """Reference attention params (constant leaves perturbed) and the port's
    ``Attention`` holding the same values."""
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(np.asarray, jattn.init_attention(
        jax.random.key(seed), d, h, hkv, dh, qkv_bias=qkv_bias,
        qk_norm=qk_norm))
    if qkv_bias:
        for k in ("wq_bias", "wk_bias", "wv_bias"):
            jp[k] = rng.normal(size=jp[k].shape).astype(np.float32) * 0.1
    if qk_norm:
        for k in ("q_norm", "k_norm"):
            jp[k] = {"scale": 1 + 0.1 * rng.normal(size=dh).astype(np.float32)}
    p = attention.Attention(d, h, hkv, dh, qkv_bias=qkv_bias, qk_norm=qk_norm)
    for k in ("wq", "wk", "wv", "wo"):
        getattr(p, k).weight.data = t(jp[k].T)
        if qkv_bias and k != "wo":
            getattr(p, k).bias.data = t(jp[f"{k}_bias"])
    if qk_norm:
        p.q_norm.scale.data = t(jp["q_norm"]["scale"])
        p.k_norm.scale.data = t(jp["k_norm"]["scale"])
    return jp, p


def test_sdpa_gqa_matches_reference():
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 5, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, 7, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, 7, 2, 8)).astype(np.float32)
    mask = rng.uniform(size=(2, 5, 7)) < 0.7
    mask[:, :, 0] = True
    close(attention._sdpa(t(q), t(k), t(v), t(mask), 8 ** -0.5),
          jattn._sdpa(q, k, v, mask, 8 ** -0.5), F32_TOL, "_sdpa")
    np.testing.assert_array_equal(attention._repeat_kv(t(k), 2).numpy(),
                                  np.asarray(jattn._repeat_kv(k, 2)))


@pytest.mark.parametrize("window", [None, 4])
def test_attend_blockwise_matches_reference_and_dense(window):
    """``attend`` past ``dense_max_seq`` takes ``_blockwise_sdpa``; a KV
    block of 3 over 11 positions leaves a padded last block."""
    jp, p = attn_pair(6)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 11, 32)).astype(np.float32)
    pos = np.arange(11)
    kw = dict(n_heads=4, n_kv_heads=2, head_dim=8, rope_theta=1e4,
              window=window)
    got, (k, v) = attention.attend(p, t(x), t(pos), dense_max_seq=4,
                                   kv_block=3, **kw)
    want, (jk, jv) = jattn.attend(jp, x, jnp.asarray(pos), policy=POLICY,
                                  dense_max_seq=4, kv_block=3, **kw)
    close(got, want, F32_TOL, "blockwise attend")
    close(k, jk, F32_TOL, "k")
    close(v, jv, F32_TOL, "v")
    dense, _ = attention.attend(p, t(x), t(pos), dense_max_seq=64, **kw)
    close(got, dense, F32_TOL, "blockwise vs dense")


@pytest.mark.parametrize("s,cache_len", [(5, 8), (8, 8), (11, 4)])
def test_cache_from_prefill_matches_reference(s, cache_len):
    """Padded (s <= cache_len) and rolling (s > cache_len) placement."""
    rng = np.random.default_rng(8)
    k = rng.normal(size=(2, s, 2, 4)).astype(np.float32)
    v = rng.normal(size=(2, s, 2, 4)).astype(np.float32)
    pos = np.arange(s)
    got = attention.cache_from_prefill(t(k), t(v), t(pos), cache_len)
    want = jattn.cache_from_prefill(k, v, jnp.asarray(pos), cache_len)
    for name in ("k", "v", "pos"):
        assert got[name].shape == want[name].shape
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]),
                                      err_msg=name)
    assert got["pos"].dtype == torch.int32


@pytest.mark.parametrize("window", [None, 5])
def test_decode_attend_matches_reference(window):
    """One token into a half-full cache (rolling when windowed), fp32 and
    with the reference's bf16 cache; the port writes its copy in place."""
    jp, p = attn_pair(9)
    rng = np.random.default_rng(10)
    clen = 8
    ck = rng.normal(size=(2, 2, clen, 8)).astype(np.float32)
    cv = rng.normal(size=(2, 2, clen, 8)).astype(np.float32)
    cpos = np.array([[0, 1, 2, 3, 4, -1, -1, -1], [8, 9, 2, 3, 4, 5, 6, 7]],
                    np.int32)
    pos = np.array([5, 10], np.int32)
    x = rng.normal(size=(2, 1, 32)).astype(np.float32)
    kw = dict(n_heads=4, n_kv_heads=2, head_dim=8, rope_theta=1e4,
              window=window)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        cache = {"k": t(ck).to(dt), "v": t(cv).to(dt), "pos": t(cpos.copy())}
        jcache = {"k": jnp.asarray(ck, jdt), "v": jnp.asarray(cv, jdt),
                  "pos": jnp.asarray(cpos)}
        got, out_cache = attention.decode_attend(p, t(x), cache, t(pos), **kw)
        want, jout = jattn.decode_attend(jp, x, jcache, jnp.asarray(pos),
                                         policy=POLICY, **kw)
        assert out_cache is cache
        tol = F32_TOL if dt == torch.float32 else BF16_TOL
        close(got, want, tol, f"decode_attend {dt}")
        for name in ("k", "v", "pos"):
            close(cache[name].float(), f64(jout[name]), tol, name)
        np.testing.assert_array_equal(cache["pos"].numpy(),
                                      np.asarray(jout["pos"]))


# ---------------------------------------------------------------------------
# Whole models at reduce_config width
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def reference_params(arch):
    """The reference's ``init(key(2))`` at reduced width, its constant
    leaves (norm scales, qkv biases) perturbed so they are tested too."""
    cfg = jconfigs.reduce_config(jconfigs.get_config(arch))
    params = jax.tree.map(np.asarray, jmodel.build(cfg).init(jax.random.key(2)))
    rng = np.random.default_rng(11)

    def perturb(path, leaf):
        name = jax.tree_util.keystr(path)
        if "scale" in name or path[-1].key in CONSTANT_AT_INIT:
            return leaf + 0.1 * rng.normal(size=leaf.shape).astype(np.float32)
        if "bias" in name:
            return 0.1 * rng.normal(size=leaf.shape).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(perturb, params)


def model_inputs(cfg, seed=3):
    """(tokens, extra): extra is the vlm's ``vision_embeds`` or encdec's
    ``frames`` (float32 numpy), else None."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S))
    extra = None
    if cfg.family == "vlm":
        extra = (rng.normal(size=(B, cfg.n_vision_tokens, cfg.d_model))
                 * 0.5).astype(np.float32)
    if cfg.family == "encdec":
        extra = (rng.normal(size=(B, cfg.enc_seq, cfg.d_model))
                 * 0.5).astype(np.float32)
    return tokens, extra


def extra_name(cfg) -> str:
    return "frames" if cfg.family == "encdec" else "vision_embeds"


def both(arch, dtype):
    """(port cfg, port params, reference cfg, reference params) in dtype."""
    cfg = configs.reduce_config(configs.get_config(arch))
    jcfg = jconfigs.reduce_config(jconfigs.get_config(arch))
    jp = reference_params(arch)
    params = lm_params_from_reference(cfg, jp, "cpu")
    if dtype == "bf16":
        params = params.to(torch.bfloat16)
        jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), jp)
    return cfg, params, jcfg, jp


@pytest.fixture
def float32_compute(monkeypatch):
    for mod in (transformer, whisper):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)
    for mod in (jtransformer, jwhisper):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)


def check_caches(cache, jcache, tol, what):
    """Every tensor of the cache (stacked layers and tail): the same keys,
    shapes and dtypes; positions equal, the rest within ``tol``."""
    got, want = dict(flat(cache)), dict(flat(jcache))
    assert sorted(got) == sorted(want), what
    for key, w in want.items():
        g, name = got[key], "/".join(key)
        assert str(g.dtype).split(".")[-1] == str(w.dtype), (name, g.dtype)
        if g.dtype == torch.int32:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        else:
            close(g.float(), f64(w), tol, f"{what} cache {name}")


@pytest.mark.parametrize("arch", SERVED)
def test_model_float32_matches_reference(arch, float32_compute):
    cfg, params, jcfg, jp = both(arch, "f32")
    m, jm = model.build(cfg), jmodel.build(jcfg)
    tokens, vision = model_inputs(cfg)
    name = extra_name(cfg)
    extra = {} if vision is None else {name: t(vision)}
    jextra = {} if vision is None else {name: jnp.asarray(vision)}
    logits, cache = m.prefill(params, CACHE_LEN, tokens=t(tokens), **extra)
    jlogits, jcache = jax.jit(lambda p, tk: jm.prefill(
        POLICY, p, CACHE_LEN, tokens=tk, **jextra))(jp, jnp.asarray(tokens))
    close(logits, jlogits, F32_TOL, f"{arch} prefill logits")
    check_caches(cache, jcache, F32_TOL, arch)
    train_logits, aux = m.apply_train(params, tokens=t(tokens), **extra)
    jtrain, jaux = jax.jit(lambda p, tk: jm.apply_train(
        POLICY, p, tokens=tk, **jextra))(jp, jnp.asarray(tokens))
    assert train_logits.dtype == torch.float32
    close(aux, jaux, F32_TOL, f"{arch} aux")      # exactly 0 without MoE
    close(train_logits, jtrain, F32_TOL, f"{arch} apply_train")


@pytest.mark.parametrize("arch", SERVED)
def test_model_bf16_prefill_and_decode_match_reference(arch):
    """bf16 prefill, then DECODE_STEPS greedy steps fed the reference's
    tokens; each package decodes from its own cache."""
    cfg, params, jcfg, jp = both(arch, "bf16")
    m, jm = model.build(cfg), jmodel.build(jcfg)
    tokens, vision = model_inputs(cfg)
    name = extra_name(cfg)
    extra = {} if vision is None else {name: t(vision).to(torch.bfloat16)}
    jextra = {} if vision is None else {name: jnp.asarray(vision, jnp.bfloat16)}
    logits, cache = m.prefill(params, CACHE_LEN, tokens=t(tokens), **extra)
    jlogits, jcache = jax.jit(lambda p, tk: jm.prefill(
        POLICY, p, CACHE_LEN, tokens=tk, **jextra))(jp, jnp.asarray(tokens))
    close(logits, jlogits, BF16_TOL, f"{arch} bf16 prefill logits")
    checked = greedy_equal(logits, jlogits, BF16_TOL, f"{arch} prefill greedy")
    check_caches(cache, jcache, BF16_TOL, f"{arch} bf16")
    step = jax.jit(lambda p, tok, c, pos: jm.decode_step(POLICY, p, tok, c, pos))
    n0 = S + (cfg.n_vision_tokens if cfg.family == "vlm" else 0)
    tok = np.asarray(jnp.argmax(jlogits, -1))[:, None].astype(np.int32)
    for i in range(DECODE_STEPS):
        pos = np.full((B,), n0 + i, np.int32)
        logits, cache = m.decode_step(params, t(tok), cache, t(pos))
        jlogits, jcache = step(jp, jnp.asarray(tok), jcache, jnp.asarray(pos))
        close(logits, jlogits, BF16_TOL, f"{arch} decode {i}")
        checked += greedy_equal(logits, jlogits, BF16_TOL,
                                f"{arch} decode {i} greedy")
        tok = np.asarray(jnp.argmax(jlogits, -1))[:, None].astype(np.int32)
    check_caches(cache, jcache, BF16_TOL, f"{arch} after decode")
    assert checked > 0, "no greedy token had a margin to test"


@pytest.mark.parametrize("arch", SERVED)
def test_prefill_decode_consistency(arch, float32_compute):
    """The port against itself, in float32: prefill(S) then one decode step
    equals prefill(S + 1); without a vision prefix, S decode steps from an
    empty cache equal prefill(S) (whisper's from the prefill of the first
    token, whose one encoder pass fills the cross K/V, as the reference's
    smoke test does)."""
    cfg = configs.reduce_config(configs.get_config(arch))
    m = model.build(cfg)
    params = m.init(torch.Generator().manual_seed(4))
    rng = np.random.default_rng(5)
    tokens = t(rng.integers(0, cfg.vocab, (B, S + 1)))
    extra, n_vis = {}, 0
    if cfg.family == "vlm":
        n_vis = cfg.n_vision_tokens
        extra["vision_embeds"] = t(rng.normal(
            size=(B, n_vis, cfg.d_model)).astype(np.float32))
    if cfg.family == "encdec":
        extra["frames"] = t(rng.normal(
            size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    full, _ = m.prefill(params, CACHE_LEN, tokens=tokens, **extra)
    part, cache = m.prefill(params, CACHE_LEN, tokens=tokens[:, :S], **extra)
    pos = torch.full((B,), n_vis + S, dtype=torch.int32)
    step, _ = m.decode_step(params, tokens[:, S:], cache, pos)
    close(step, full, 1e-4, f"{arch} prefill+decode vs prefill")
    if n_vis:
        return
    if cfg.family == "encdec":
        _, cache = m.prefill(params, CACHE_LEN, tokens=tokens[:, :1], **extra)
        first, blocks = 1, {"layers": cache["layers"]}
    else:
        cache = transformer.init_cache(cfg, B, CACHE_LEN, dtype=torch.float32,
                                       device="cpu")
        first, blocks = 0, cache["layers"]
    for i in range(first, S + 1):
        logits, cache = m.decode_step(params, tokens[:, i:i + 1], cache,
                                      torch.full((B,), i, dtype=torch.int32))
    close(logits, full, 1e-4, f"{arch} decode steps vs prefill")
    for key, block in blocks.items():
        if "pos" in block:          # position p in slot p % cache length
            want = np.full(block["pos"].shape[-1], -1)
            for p in range(S + 1):
                want[p % want.size] = p
            np.testing.assert_array_equal(
                block["pos"].numpy(), np.broadcast_to(want, block["pos"].shape),
                err_msg=key)


@pytest.mark.parametrize("arch", SERVED)
def test_lm_params_from_reference_round_trip(arch):
    """Every reference leaf lands in exactly one port parameter (stacked
    leaves once per layer), transposed where nn.Linear wants (out, in),
    and no parameter is left over; a stray or a missing leaf raises."""
    cfg = configs.reduce_config(configs.get_config(arch))
    jp = reference_params(arch)
    named = {name: p.detach().numpy() for name, p in
             lm_params_from_reference(cfg, jp, "cpu").named_parameters()}
    owner = {}
    for path, leaf in flat(jp):
        keys = "/".join(path)
        stacked = keys.startswith(("layers/", "enc_layers/"))
        for a in (leaf if stacked else [leaf]):
            # an nn.Linear ``weight`` holds the reference's (in, out) as (out, in)
            hits = [name for name, p in named.items()
                    if np.array_equal(p, a.T if name.endswith(".weight") else a)]
            assert len(hits) == 1, (keys, hits)
            assert hits[0] not in owner, (keys, owner.get(hits[0]))
            owner[hits[0]] = keys
    assert set(owner) == set(named), sorted(set(named) - set(owner))
    stray = dict(jp, extra={"w": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="no port parameter"):
        lm_params_from_reference(cfg, stray, "cpu")
    missing = {k: v for k, v in jp.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="no reference leaf"):
        lm_params_from_reference(cfg, missing, "cpu")


# ---------------------------------------------------------------------------
# Facade, serve CLI, families and devices
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", SERVED)
def test_input_and_cache_specs_match_reference(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    for shape in configs.LM_SHAPES:
        jshape = jconfigs.get_shape(shape.name)
        assert (model.effective_cache_len(cfg, shape)
                == jmodel.effective_cache_len(jcfg, jshape))
        got = dict(flat(model.cache_specs(cfg, shape)))
        want = dict(flat(jmodel.cache_specs(jcfg, jshape)))
        assert sorted(got) == sorted(want)
        for key, w in want.items():
            assert got[key][0] == w.shape, key
            assert str(got[key][1]).split(".")[-1] == str(w.dtype), key
    small = configs.reduce_config(cfg)
    jsmall = jconfigs.reduce_config(jcfg)
    for shape in configs.LM_SHAPES:
        jshape = jconfigs.get_shape(shape.name)
        got = model.input_specs(small, shape, batch_override=2,
                                seq_override=12, device="cpu")
        want = jmodel.input_specs(jsmall, jshape, batch_override=2,
                                  seq_override=12)
        assert sorted(got) == sorted(want)
        for k in got:
            assert tuple(got[k].shape) == want[k].shape, k
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
            assert not got[k].any()


def test_serve_main_on_cpu(capsys):
    res = serve.main(["--device", "cpu", "--reduced"])
    out = capsys.readouterr().out
    assert "arch=qwen3-1.7b (reduced) batch=4" in out
    assert "prefill:" in out and "decode:" in out and "[1]" in out
    assert res["generations"].shape == (4, 16)
    assert res["peak_bytes"] is None and res["device"] == "cpu"
    for key in ("prefill_ms", "prefill_tok_s", "decode_ms_per_step",
                "decode_tok_s"):
        assert np.isfinite(res[key]) and res[key] > 0, key
    cfg = configs.reduce_config(configs.get_config("qwen3-1.7b"))
    m = model.build(cfg)
    params = serve.init_bf16(m, torch.device("cpu"))
    # the analytic count leaves out the norm scales
    norms = cfg.n_layers * (2 * cfg.d_model + 2 * cfg.head_dim_) + cfg.d_model
    assert res["param_count"] == cfg.param_count() + norms
    assert res["param_bytes"] == 2 * res["param_count"]
    logits, _ = m.prefill(params, 48, tokens=serve.make_prompts(cfg, 4, 32, "cpu"))
    np.testing.assert_array_equal(res["generations"][:, 0],
                                  logits.argmax(-1).numpy())
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--reduced", "--arch",
                    "llava-next-mistral-7b"])


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = configs.reduce_config(configs.get_config("qwen3-1.7b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.build(cfg).init_cache(1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.input_specs(cfg, configs.get_shape("decode_32k"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--reduced"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm_params_from_reference(cfg, reference_params("qwen3-1.7b"), "cuda")
