"""DeepSeek-V2-Lite on the port (``MLAConfig``): multi-head latent
attention, YaRN, the latent decode cache, the dense head block and the
held-expert MoE layer, held on the CPU at the tests' size against the
plain float32 reference ``tmbench/reference/deepseek_v2.py`` (the one
copy the benchmark uses too) on seeded random weights.

* one MLA block, float32, to 1e-5 of max|ref|;
* a train step's loss and gradients, float32 (1e-5) and bf16 (2e-2);
* a whole train step (two microbatches, the clip, AdamW) in float32: the
  parameters' change and the first moment against the reference's update;
* prefill, then decode through the latent cache, against the reference's
  full-sequence logits (2e-2 of max|logit|), the cache holding only the
  latent ``c`` and the rope key ``k_R`` per layer;
* the 8 shares of a held-expert layer, the shared experts counted once,
  add up to the uncut reference layer;
* YaRN's ``low``/``high`` and softmax scale at the published config;
* the MoE counters: kept + dropped + absent = tokens × top_k, once a layer
  whatever the recompute;
* ``ARCHS`` and every existing config untouched; MLA under a mesh raises;
  the parameter count; the launch CLIs take the architecture;
* the attention core kernels' algorithm (``kernels/mla_attention.py``:
  tiled online softmax, saved logsumexp, dS = P (dP - D)), in plain
  PyTorch here, against autograd through ``_sdpa`` in float32, over a
  ragged S, -1 slots and positions that are no ``arange``; CPU operands
  keep ``_sdpa``; the core's backward is attributed to ``lm.mla.core`` by
  ``tmbench/lm_spans.py``'s rule.
"""
import dataclasses
import math

import pytest
import torch

from repro_torch import spans, steps
from repro_torch.configs import (
    ARCHS,
    PORT_ARCHS,
    get_config,
    reduce_config,
)
from repro_torch.configs.base import MLAConfig, ModelConfig, ShapeSpec
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention, moe, transformer
from repro_torch.models.common import yarn_range
from tmbench import harness, lm_serve_check
from tmbench.reference import deepseek_v2 as ref

FAMILY = harness.family_module("lm")
CONF = {**harness.load_json(harness.ROOT / "tmbench/configs/deepseek_v2_lite_ep8.json"),
        **FAMILY.TINY}
CFG = FAMILY.config(CONF)
SEED = 2**31 + 7
ASSIGNED = ("llava-next-mistral-7b", "whisper-medium", "qwen3-1.7b",
            "granite-8b", "qwen2-72b", "minitron-4b", "rwkv6-3b",
            "recurrentgemma-9b", "mixtral-8x7b", "qwen2-moe-a2.7b")


def _params(cfg=CFG, seed=SEED):
    return transformer.init_params(torch.Generator().manual_seed(seed), cfg)


def _batch(cfg=CFG, rows=2, seq=40, seed=SEED + 1):
    ids = torch.randint(0, cfg.vocab, (rows, seq + 1),
                        generator=torch.Generator().manual_seed(seed))
    return {"tokens": ids[:, :-1].to(torch.int32), "labels": ids[:, 1:].to(torch.int32)}


def _rel(a, b):
    a, b = a.detach(), b.detach()
    return float((a - b).abs().max() / b.abs().max())


def test_the_cut_has_every_kind_of_layer():
    assert isinstance(CFG, MLAConfig) and CFG.n_dense_layers == 1
    assert CFG.n_held < CFG.n_experts and CFG.v_head_dim != CFG.qk_head_dim
    p = _params()
    assert len(p.head) == 1 and hasattr(p.head[0], "mlp")
    assert all(hasattr(g["b0_attn_moe"], "moe") for g in p.layers)
    assert p.layers[0]["b0_attn_moe"].moe.w_down.shape[0] == CFG.n_held


def test_mla_block_matches_the_reference_in_float32():
    p = _params()
    w = FAMILY.reference_weights(p)
    x = torch.randn(2, 24, CFG.d_model, generator=torch.Generator().manual_seed(5))
    got, (c, k_r) = attention.mla_attend(p.head[0].attn, CFG, x,
                                         torch.arange(24)[None])
    want = ref.mla(w["layers"][0], x, CONF)
    assert _rel(got, want) < 1e-5
    assert c.shape == (2, 24, CFG.kv_lora_rank)
    assert k_r.shape == (2, 24, CFG.qk_rope_head_dim)


def _grads(p, names):
    named = dict(p.named_parameters())
    return {n: named[n].grad.clone() for n in names}


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)],
                         ids=["float32", "bf16"])
def test_train_loss_and_grads_match_the_reference(monkeypatch, dtype, tol):
    p, mb = _params(), _batch()
    names = [f"layers.0.b0_attn_moe.attn.{w}.weight"
             for w in ("wq", "wkv_a", "wkv_b", "wo")]
    if dtype == torch.float32:
        monkeypatch.setattr(steps, "COMPUTE_DTYPE", torch.float32)
        monkeypatch.setattr(transformer, "COMPUTE_DTYPE", torch.float32)
        names += ["layers.1.b0_attn_moe.moe.router",
                  "layers.1.b0_attn_moe.moe.w_down", "embed.tokens"]
    loss, _, logits = steps.train_loss(CFG, p, mb,
                                       aux_coef=CONF["aux_loss_alpha"])
    loss.backward()
    got = _grads(p, names)
    for q in p.parameters():
        q.grad = None
    want_loss, want_logits = ref.loss(FAMILY.reference_weights(p), mb["tokens"],
                                      mb["labels"], CONF, (0, CFG.n_held))
    want_loss.backward()
    want = _grads(p, names)
    assert abs(float(loss.detach()) - float(want_loss.detach())) < tol
    assert _rel(logits, want_logits) < tol
    for n in names:
        g, r = got[n], want[n]
        assert float((g - r).norm() / r.norm()) < tol, n


def test_a_train_step_matches_the_reference_update_in_float32(monkeypatch):
    monkeypatch.setattr(steps, "COMPUTE_DTYPE", torch.float32)
    monkeypatch.setattr(transformer, "COMPUTE_DTYPE", torch.float32)
    opt = CONF["optimizer"]
    p, batch = _params(), _batch(rows=4)
    state = steps.init_train_state(p)
    step = steps.make_step(CFG, ShapeSpec("t", "train", 40, 4), microbatches=2,
                           aux_coef=CONF["aux_loss_alpha"], peak_lr=opt["peak_lr"],
                           warmup_steps=opt["warmup_steps"],
                           total_steps=opt["total_steps"]).fn
    state, _ = step(state, _batch(rows=4, seed=SEED + 2))
    named = dict(p.named_parameters())
    names = ["layers.0.b0_attn_moe.attn.wq.weight", "layers.1.b0_attn_moe.moe.router",
             "head.0.mlp.w_down.weight", "lm_head.weight"]
    theta = {n: named[n].detach().clone() for n in names}
    m0 = {n: state["opt"].mu[n].clone() for n in names}
    v0 = {n: state["opt"].nu[n].clone() for n in names}
    count = int(state["opt"].step)
    for q in p.parameters():
        q.grad = None
    for i in range(2):
        want_loss, _ = ref.loss(FAMILY.reference_weights(p), batch["tokens"][2 * i:2 * i + 2],
                                batch["labels"][2 * i:2 * i + 2], CONF, (0, CFG.n_held))
        want_loss.backward()
    gnorm = float(torch.stack([q.grad.norm() for q in p.parameters()
                               if q.grad is not None]).norm()) / 2
    want = {n: ref.adamw(theta[n], named[n].grad / 2, m0[n], v0[n], count, gnorm, opt)
            for n in names}
    for q in p.parameters():
        q.grad = None
    state, metrics = step(state, batch)
    assert float(metrics["grad_norm"]) == pytest.approx(gnorm, rel=1e-5)
    for n in names:
        delta, m1 = want[n]
        # the change is read back from float32 masters: at the second step's
        # learning rate (3e-6) their rounding alone is ~3e-3 of it
        assert float((named[n].detach() - theta[n] - delta).norm() / delta.norm()) < 1e-2, n
        assert float((state["opt"].mu[n] - m1).norm() / m1.norm()) < 1e-5, n


def test_prefill_then_decode_through_the_latent_cache_matches_the_reference():
    row = lm_serve_check.check(CONF, SEED, 2, 32, 8, torch.device("cpu"))
    assert row["logits_err"] < 2e-2
    r, dr = CFG.kv_lora_rank, CFG.qk_rope_head_dim
    stacked = CFG.n_layers - CFG.n_dense_layers
    assert row["cache"] == {
        "b0_attn_moe": {"c": [stacked, 2, 40, r], "kr": [stacked, 2, 40, dr],
                        "pos": [stacked, 2, 40]},
        "head.0": {"c": [2, 40, r], "kr": [2, 40, dr], "pos": [2, 40]}}
    assert row["cache_bytes_per_token_layer"] == 2 * (r + dr)


def test_the_published_latent_cache_is_1152_bytes_a_token_a_layer():
    cfg = get_config("deepseek-v2-lite")
    shapes = transformer.cache_shapes(cfg, 1, 8)
    block = shapes["layers"]["b0_attn_moe"]
    assert set(block) == {"c", "kr", "pos"}
    per = sum(shape[-1] * 2 for name, (shape, _) in block.items() if name != "pos")
    assert per == 1152 and block["c"][0] == (26, 1, 8, 512)


def test_the_shares_of_a_held_expert_layer_add_up_to_the_uncut_layer():
    e, n_held, d = 16, 2, CFG.d_model
    full = moe.init_moe(torch.Generator().manual_seed(11), d, 32, e,
                        n_shared=2, shared_gate=False)
    x = torch.randn(2, 40, d, generator=torch.Generator().manual_seed(12))
    kw = dict(top_k=3, capacity_factor=1.25, normalize=False)
    total = torch.zeros_like(x)
    for share in range(e // n_held):
        part = moe.MoE(d, 32, e, n_shared=2, n_held=n_held, shared_gate=False)
        rows = slice(share * n_held, (share + 1) * n_held)
        with torch.no_grad():
            for name, t in full.named_parameters():
                held = name in ("w_gate", "w_up", "w_down")
                dict(part.named_parameters())[name].copy_(t[rows] if held else t)
        out, _ = moe.moe_block(part, x, base=share * n_held, **kw)
        total += out
    shared = moe.shared_out(full, x)
    total -= (e // n_held - 1) * shared
    conf = {"n_routed_experts": e, "num_experts_per_tok": 3,
            "norm_topk_prob": False, "routed_scaling_factor": 1,
            "capacity_factor": 1.25}
    w = {"router": full.router, "shared": {k: getattr(full.shared, k).weight
                                           for k in ("w_gate", "w_up", "w_down")},
         "experts": {k: getattr(full, k) for k in ("w_gate", "w_up", "w_down")}}
    with torch.no_grad():
        want, _ = ref.moe(w, x, conf, (0, e), train=True)
    assert _rel(total, want) < 1e-5


def test_yarn_at_the_published_config():
    cfg = get_config("deepseek-v2-lite")
    assert yarn_range(64, 1e4, 32, 1, 4096) == (10, 23)
    assert ref.yarn_range(64, 1e4, 32, 1, 4096) == (10, 23)
    assert attention.mla_scale(cfg) == pytest.approx(0.1147213867929261, rel=1e-12)
    conf = harness.load_json(harness.ROOT / "tmbench/configs/deepseek_v2_lite_ep8.json")
    assert ref.softmax_scale(conf) == pytest.approx(0.1147213867929261, rel=1e-12)


def test_the_moe_counters_sum_to_tokens_times_top_k_once_a_layer():
    cfg = dataclasses.replace(CFG, remat=True)
    state = steps.init_train_state(_params(cfg))
    step = steps.make_step(cfg, ShapeSpec("t", "train", 40, 4), microbatches=2).fn
    with spans.counting() as counts:
        step(state, _batch(cfg, rows=4))
    moe_layers = cfg.n_layers - cfg.n_dense_layers
    got = {k: int(v) for k, v in counts.items()}
    assert sum(got.values()) == 4 * 40 * cfg.top_k * moe_layers
    assert got["lm.moe.absent"] > 0 and got["lm.moe.kept"] > 0


def test_archs_and_every_existing_config_are_unchanged():
    assert ARCHS == ASSIGNED and PORT_ARCHS == ("deepseek-v2-lite",)
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    for arch in ARCHS:
        cfg = get_config(arch)
        assert type(cfg) is ModelConfig and set(dataclasses.asdict(cfg)) == fields
    assert isinstance(get_config("deepseek-v2-lite"), MLAConfig)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_mla_under_a_mesh_names_mla(kind):
    with pytest.raises(NotImplementedError, match="MLA"):
        steps.make_step(CFG, ShapeSpec("t", kind, 16, 4), make_mesh(2, 2, device="cpu"))


def test_the_parameter_count_is_the_modules():
    assert CFG.param_count() == sum(t.numel() for t in _params().parameters())
    cut = dataclasses.replace(get_config("deepseek-v2-lite"), experts_held=8,
                              vocab=12800)
    meta = transformer.LM(cut, torch.device("meta"))
    assert cut.param_count() == sum(t.numel() for t in meta.parameters()) == 2_743_987_712
    assert cut.active_param_count() < cut.param_count()


def test_the_launch_clis_take_the_architecture(tmp_path):
    from repro_torch.launch import serve, train

    out = serve.main(["--arch", "deepseek-v2-lite", "--reduced", "--device",
                      "cpu", "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    assert out["generations"].shape == (2, 3)
    res = train.main(["--arch", "deepseek-v2-lite", "--reduced", "--device",
                      "cpu", "--steps", "1", "--batch", "2", "--seq", "8",
                      "--ckpt-dir", str(tmp_path)])
    assert res["end_step"] == 1
    assert isinstance(reduce_config(get_config("deepseek-v2-lite")), MLAConfig)


def test_a_train_step_records_its_spans_and_again_in_the_recompute():
    from torch.profiler import ProfilerActivity, profile

    cfg = dataclasses.replace(CFG, remat=True)
    state = steps.init_train_state(_params(cfg))
    step = steps.make_step(cfg, ShapeSpec("t", "train", 16, 4), microbatches=2).fn
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, _batch(cfg, rows=4, seq=16))
    names = [e.name for e in prof.events() if e.name.startswith("lm.")]
    count = {n: names.count(n) for n in set(names)}
    moe_layers = cfg.n_layers - cfg.n_dense_layers
    assert count["lm.train_step"] == 1 and count["lm.optimizer"] == 1
    assert count["lm.microbatch"] == 2 and count["lm.embed"] == 2
    # each block once forward and once in its recompute, per microbatch
    assert count["lm.mla"] == count["lm.mla.core"] == 2 * 2 * cfg.n_layers
    assert count["lm.moe"] == count["lm.moe.route"] == 2 * 2 * moe_layers
    assert count["lm.mlp"] == 2 * 2 * cfg.n_dense_layers
    assert count["lm.head_loss"] == 2 * 2


# -- the attention core's algorithm in plain PyTorch (kernels/mla_attention.py) -
def _core_inputs(s, dqk, dv, pos, heads=2, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q, k = (torch.randn(2, s, heads, dqk, generator=gen) for _ in range(2))
    v = torch.randn(2, s, heads, dv, generator=gen)
    dout = torch.randn(2, s, heads, dv, generator=gen)
    return q, k, v, dout, pos


def _positions(kind, s):
    pos = torch.arange(s).repeat(2, 1)
    if kind == "minus_one_slots":        # empty slots: rows that see every key
        pos[0, 5::9] = -1
        pos[1, 30:45] = -1
    elif kind == "not_arange":           # a permutation, repeats, -1 slots
        pos[0] = torch.randperm(s, generator=torch.Generator().manual_seed(s))
        pos[1] = torch.arange(s) // 3
        pos[0, ::13] = -1
    return pos


def _sdpa_and_grads(q, k, v, dout, pos, scale):
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    out = attention._sdpa(*ts, attention._mask(pos, pos, "causal", None), scale)
    out.backward(dout)
    return [out.detach()] + [t.grad for t in ts]


# The CUDA kernels' algorithm, tile for tile: a tiled online softmax in
# float32 (running max and denominator, in base 2), the saved logsumexp, and
# a backward that recomputes P from it with dS = P (dP - D), D = rowsum(dO O).
NEG_INF = attention.NEG_INF
LOG2E = math.log2(math.e)


def _stats(pos):
    return int(pos.min()), int(pos.max())


def _needed(q_stats, k_stats):
    """Some (query, key) pair of the two tiles matters (the kernels' skip)."""
    return q_stats[0] < 0 or k_stats[0] <= q_stats[1]


def _allowed(q_pos, k_pos):
    return (k_pos[None, :] >= 0) & (k_pos[None, :] <= q_pos[:, None])


def _dot(a, b):
    """``a @ b`` of operands rounded to their dtype, accumulated in float32."""
    return torch.matmul(a.float(), b.float())


def attention_plain(q, k, v, pos, scale, block_q=128, block_k=64):
    """q, k (B, S, H, Dqk), v (B, S, H, Dv), pos (B, S) -> (out in q's
    dtype, lse (B, H, S) float32: the row max plus log2 of the denominator
    in ``scale log2 e`` units, NEG_INF for a row with no allowed key)."""
    b_, s_, h_, _ = q.shape
    c = scale * LOG2E
    out = torch.empty((b_, s_, h_, v.shape[-1]), dtype=q.dtype)
    lse = torch.empty((b_, h_, s_), dtype=torch.float32)
    for b in range(b_):
        for q0 in range(0, s_, block_q):
            qp = pos[b, q0:q0 + block_q]
            qs = _stats(qp)
            qt = q[b, q0:q0 + block_q].transpose(0, 1)          # (H, bq, D)
            m = torch.full((h_, qp.numel()), NEG_INF, dtype=torch.float32)
            l = torch.zeros_like(m)
            acc = torch.zeros((h_, qp.numel(), v.shape[-1]), dtype=torch.float32)
            for k0 in range(0, s_, block_k):
                kp = pos[b, k0:k0 + block_k]
                if not _needed(qs, _stats(kp)):
                    continue
                kt = k[b, k0:k0 + block_k].transpose(0, 1)
                vt = v[b, k0:k0 + block_k].transpose(0, 1)
                t = torch.where(_allowed(qp, kp), _dot(qt, kt.transpose(1, 2)) * c,
                                NEG_INF)
                mx = torch.maximum(m, t.amax(-1))
                alpha = torch.exp2(m - mx)
                p = torch.exp2(t - mx[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + _dot(p.to(q.dtype), vt)
                m = mx
            out[b, q0:q0 + block_q] = (acc / l[..., None]).transpose(0, 1).to(q.dtype)
            lse[b, :, q0:q0 + block_q] = torch.where(m == NEG_INF, NEG_INF,
                                                     m + torch.log2(l))
    return out, lse


def attention_plain_backward(q, k, v, pos, scale, out, lse, dout, block_q=64,
                             block_k=64):
    """(dq, dk, dv) in q's dtype: P recomputed as ``exp2(t - lse)`` (1/S in
    a row with no allowed key), ``dS = P (dP - D) scale`` zero where masked,
    P and dS rounded to q's dtype for the products."""
    b_, s_, h_, _ = q.shape
    c = scale * LOG2E
    dt = q.dtype
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)   # (B, H, S)
    dq = torch.zeros(q.shape, dtype=torch.float32)
    dk = torch.empty(k.shape, dtype=dt)
    dv = torch.empty(v.shape, dtype=dt)
    for b in range(b_):
        for k0 in range(0, s_, block_k):
            kp = pos[b, k0:k0 + block_k]
            ks = _stats(kp)
            kt = k[b, k0:k0 + block_k].transpose(0, 1)          # (H, bk, D)
            vt = v[b, k0:k0 + block_k].transpose(0, 1)
            dk_acc = torch.zeros(kt.shape, dtype=torch.float32)
            dv_acc = torch.zeros(vt.shape, dtype=torch.float32)
            for q0 in range(0, s_, block_q):
                qp = pos[b, q0:q0 + block_q]
                if not _needed(_stats(qp), ks):
                    continue
                qt = q[b, q0:q0 + block_q].transpose(0, 1)
                dot = dout[b, q0:q0 + block_q].transpose(0, 1)
                ok = _allowed(qp, kp)
                row = lse[b, :, q0:q0 + block_q, None]
                t = _dot(qt, kt.transpose(1, 2)) * c
                p = torch.where(ok, torch.exp2(t - row),
                                torch.where(row == NEG_INF, 1.0 / s_, 0.0))
                dp = _dot(dot, vt.transpose(1, 2))
                ds = torch.where(ok, p * (dp - delta[b, :, q0:q0 + block_q, None]) * scale,
                                 0.0)
                p, ds = p.to(dt), ds.to(dt)
                dv_acc += _dot(p.transpose(1, 2), dot)
                dk_acc += _dot(ds.transpose(1, 2), qt)
                dq[b, q0:q0 + block_q] += _dot(ds, kt).transpose(0, 1)
            dk[b, k0:k0 + block_k] = dk_acc.transpose(0, 1).to(dt)
            dv[b, k0:k0 + block_k] = dv_acc.transpose(0, 1).to(dt)
    return dq.to(dt), dk, dv


def _plain_kernels(monkeypatch):
    """The autograd Function with the plain algorithm in the kernels' place,
    so that it runs on the CPU."""
    from repro_torch.kernels import mla_attention as core

    def fwd(q, k, v, pos, scale):
        return (*attention_plain(q, k, v, pos, scale), torch.empty(0))

    def bwd(q, k, v, pos, stats, out, lse, dout, scale):
        return attention_plain_backward(q, k, v, pos, scale, out, lse, dout)
    monkeypatch.setattr(core, "attention_fwd", fwd)
    monkeypatch.setattr(core, "attention_bwd", bwd)
    return core


def _close(got, want, names=("out", "dq", "dk", "dv")):
    scale = max(float(w.abs().max()) for w in want)
    for name, a, b in zip(names, got, want):
        assert float((a - b).abs().max()) <= 1e-5 * scale, name


@pytest.mark.parametrize("s, dqk, dv, kind", [
    (1, 192, 128, "arange"), (77, 192, 128, "arange"), (300, 192, 128, "arange"),
    (77, 64, 64, "minus_one_slots"), (300, 192, 128, "not_arange"),
    (77, 32, 32, "arange")])
def test_the_core_plain_body_matches_autograd_through_sdpa(monkeypatch, s, dqk, dv,
                                                           kind):
    """The kernels' algorithm (tiled online softmax, the saved logsumexp and
    dS = P (dP - D)), at small tiles over a ragged S, in float32, against
    autograd through ``_sdpa``; and the autograd Function around it (the
    kernels' tiles) on the CPU."""
    q, k, v, dout, pos = _core_inputs(s, dqk, dv, _positions(kind, s), seed=s)
    want = _sdpa_and_grads(q, k, v, dout, pos, 0.11)
    out, lse = attention_plain(q, k, v, pos, 0.11, block_q=32, block_k=16)
    assert lse.shape == (2, 2, s) and lse.dtype == torch.float32
    grads = attention_plain_backward(q, k, v, pos, 0.11, out, lse, dout,
                                     block_q=16, block_k=32)
    _close([out, *grads], want)
    core = _plain_kernels(monkeypatch)
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    got = core.mla_attention(*ts, pos, 0.11)
    got.backward(dout)
    _close([got.detach()] + [t.grad for t in ts], want)


def test_rows_with_no_allowed_key_attend_to_every_key_as_sdpa_does():
    q, k, v, _, pos = _core_inputs(40, 16, 8, torch.full((2, 40), -1))
    out, lse = attention_plain(q, k, v, pos, 0.5, block_q=16, block_k=8)
    assert (lse == NEG_INF).all()
    torch.testing.assert_close(out, v.mean(1, keepdim=True).expand_as(out))


def test_the_kernels_function_refuses_cpu_operands():
    """The kernels' Function has no CPU body: a CPU call raises, so that
    only ``mla_attend``'s own dispatch sends CPU operands to ``_sdpa``."""
    from repro_torch.kernels import mla_attention as core

    q, k, v, _, pos = _core_inputs(8, 192, 128, torch.arange(8).repeat(2, 1))
    with pytest.raises(ValueError, match="CUDA"):
        core.mla_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), pos, 0.1)


def test_mla_attend_on_the_cpu_takes_sdpa(monkeypatch):
    """CPU operands, float32 or bf16, keep ``_sdpa``: the kernels' Function
    is never applied and nothing launches."""
    from repro_torch.kernels import mla_attention as core

    calls = []
    sdpa = attention._sdpa

    def counting(*a, **kw):
        calls.append(a[0].dtype)
        return sdpa(*a, **kw)

    def refuse(*a, **kw):
        raise AssertionError("the kernels' Function on the CPU path")
    monkeypatch.setattr(attention, "_sdpa", counting)
    monkeypatch.setattr(core.MLACore, "apply", refuse)
    launches = core.attention_fwd.launches, core.attention_bwd.launches
    p = _params().head[0].attn
    x = torch.randn(2, 24, CFG.d_model, generator=torch.Generator().manual_seed(5))
    attention.mla_attend(p, CFG, x, torch.arange(24)[None])
    attention.mla_attend(p.to(torch.bfloat16), CFG, x.to(torch.bfloat16),
                         torch.arange(24)[None])
    assert calls == [torch.float32, torch.bfloat16]
    assert (core.attention_fwd.launches, core.attention_bwd.launches) == launches


def test_the_core_backward_is_attributed_to_lm_mla_core(monkeypatch, tmp_path):
    """The Function's backward operator carries the ``Sequence number`` of
    its forward operator, so ``tmbench/lm_spans.py``'s rule gives a kernel
    launched in the backward to ``lm.mla.core``, as one launched in the
    forward: without it the backward's device time would drop out of
    ``lm.mla``."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from tmbench import lm_spans

    core = _plain_kernels(monkeypatch)

    q, k, v, dout, pos = _core_inputs(24, 16, 8, torch.arange(24)[None].expand(2, 24))
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("lm.train_step"):
            with spans.span("lm.mla"):
                x = ts[0] * 1.0
                with spans.span("lm.mla.core"):
                    out = core.mla_attention(x, ts[1], ts[2], pos, 0.25)
                y = (out * dout).sum()
            y.backward()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    fwd = [e for e in ops if e["name"] == "MLACore"]
    bwd = [e for e in ops if e["name"].startswith(lm_spans.BACKWARD)
           and "MLACore" in e["name"]]
    assert len(fwd) == 1 and len(bwd) == 1
    assert bwd[0]["args"]["Sequence number"] == fwd[0]["args"]["Sequence number"]

    def launch(op, corr):   # a launch inside the operator, on its thread
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": op["ts"] + op["dur"] / 2, "dur": 0, "pid": op["pid"],
                "tid": op["tid"], "args": {"correlation": corr}}
    events += [launch(fwd[0], 90001), launch(bwd[0], 90002)]
    events += [{"ph": "X", "cat": "kernel", "name": f"k{c}", "ts": 0, "dur": d,
                "pid": 0, "tid": 99, "args": {"correlation": c}}
               for c, d in ((90001, 3.0), (90002, 5.0))]
    got = lm_spans.device_by_span(events)
    assert got["device_s"]["lm.mla.core"] == pytest.approx(8e-6)
    assert got["launches"]["lm.mla.core"] == 2
