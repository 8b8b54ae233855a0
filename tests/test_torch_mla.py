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
  the parameter count; the launch CLIs take the architecture.
"""
import dataclasses

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
