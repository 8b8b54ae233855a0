"""The LM family: a configuration file (``tmbench/configs/*.json`` with
``"family": "lm"``) that holds a DeepSeek-V2-style model's public
``config.json`` under its own keys, read as the port's ``MLAConfig``.

Every published width runs as published. What a file may cut is the chip's
share of an expert-parallel deployment, under keys of its own beside the
published ones: ``experts_held`` (the experts each MoE layer holds and
computes, of its router's ``n_routed_experts``) and ``vocab`` (the rows of
the vocabulary held, of ``vocab_size``; the traffic draws its ids from
them). Training: ``capacity_factor``, ``optimizer`` (the step's schedule
and AdamW's settings); ``aux_loss_alpha`` is the published coefficient.

Its control (``tmbench.control``): the reference put in the program's
place in the comparison, one precision below the configuration's bfloat16
(the latent and the attention's activations rounded through
``float8_e4m3fn``). Its planted faults (``FAULTS``, run with ``python3 -m
tmbench.lm_control``): the rope key left unrotated (``rope_dropped``), the
latent not normed (``latent_unnormed``), YaRN's ``m²`` left out of the
softmax scale (``softmax_unscaled``), a sigmoid gate on the shared experts
(``shared_gated``), a training step that leaves the parameters and the
moments as they were (``step_skipped``), one that takes only the first
half of its batch's rows (``half_batch``).
"""
from __future__ import annotations

import contextlib

# the published widths of each source a configuration of this family may
# name, which its file must state unchanged (with the counts it may cut)
PUBLISHED = {
    "https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite/blob/main/config.json": {
        "hidden_size": 2048, "intermediate_size": 10944,
        "moe_intermediate_size": 1408, "num_attention_heads": 16,
        "num_key_value_heads": 16, "kv_lora_rank": 512,
        "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "v_head_dim": 128,
        "num_experts_per_tok": 6, "n_routed_experts": 64,
        "n_shared_experts": 2, "vocab_size": 102400},
}
CUTS = ("experts_held", "vocab")           # the keys a file may cut
FAULTS = ("rope_dropped", "latent_unnormed", "softmax_unscaled",
          "shared_gated", "step_skipped", "half_batch")
# the CPU tests' cut: every kind of layer (a dense block, MoE blocks
# holding half of their router's experts), a value head dim unlike the
# query/key one, YaRN as published
TINY = {"num_hidden_layers": 3, "hidden_size": 64, "intermediate_size": 96,
        "moe_intermediate_size": 32, "num_attention_heads": 4,
        "num_key_value_heads": 4, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
        "qk_rope_head_dim": 8, "v_head_dim": 12, "n_routed_experts": 8,
        "num_experts_per_tok": 2, "experts_held": 4, "vocab": 96,
        "vocab_size": 192}


def config(conf: dict):
    """The ``MLAConfig`` a configuration file states (its cut applied)."""
    from repro_torch.configs.base import MLAConfig

    rs = conf["rope_scaling"]
    return MLAConfig(
        name=conf["name"], family="moe", n_layers=conf["num_hidden_layers"],
        d_model=conf["hidden_size"], n_heads=conf["num_attention_heads"],
        n_kv_heads=conf["num_key_value_heads"],
        d_ff=conf["intermediate_size"], vocab=conf["vocab"],
        head_dim=conf["v_head_dim"], rope_theta=float(conf["rope_theta"]),
        norm_eps=conf["rms_norm_eps"],
        tie_embeddings=conf["tie_word_embeddings"],
        n_experts=conf["n_routed_experts"],
        top_k=conf["num_experts_per_tok"],
        n_shared_experts=conf["n_shared_experts"],
        d_ff_expert=conf["moe_intermediate_size"],
        capacity_factor=conf["capacity_factor"],
        normalize_topk=conf["norm_topk_prob"], sp_residual=False,
        kv_lora_rank=conf["kv_lora_rank"],
        qk_nope_head_dim=conf["qk_nope_head_dim"],
        qk_rope_head_dim=conf["qk_rope_head_dim"],
        v_head_dim=conf["v_head_dim"], rope_factor=float(rs["factor"]),
        beta_fast=float(rs["beta_fast"]), beta_slow=float(rs["beta_slow"]),
        mscale=rs["mscale"], mscale_all_dim=rs["mscale_all_dim"],
        original_max_positions=rs["original_max_position_embeddings"],
        n_dense_layers=conf["first_k_dense_replace"],
        experts_held=conf["experts_held"])


def check(conf: dict, entry: dict) -> None:
    """An LM configuration's own invariants (``entry``: its entry in
    ``BENCHMARK.json``); raises ValueError."""
    name = conf["name"]
    published = conf.get("published", {})
    bad = [k for k in conf["reduced"] if k not in CUTS]
    if bad or entry["reduced"] != conf["reduced"]:
        raise ValueError(f"{name}: an LM configuration cuts only {CUTS}, "
                         f"not {bad or entry['reduced']}")
    widths = PUBLISHED.get(conf["source"])
    if widths is None:
        raise ValueError(f"{name}: no published widths known for "
                         f"{conf['source']!r}")
    for key, value in widths.items():
        if conf.get(key) != value:
            raise ValueError(f"{name}: {key} is {conf.get(key)!r}, the "
                             f"published width {value!r}")
    if published.get("experts_held") != conf["n_routed_experts"]:
        raise ValueError(f"{name}: published experts_held is not the "
                         "router's n_routed_experts")
    if published.get("vocab") != conf["vocab_size"]:
        raise ValueError(f"{name}: published vocab is not vocab_size")
    if not (1 <= conf["experts_held"] <= conf["n_routed_experts"]
            and 1 <= conf["vocab"] <= conf["vocab_size"]):
        raise ValueError(f"{name}: a share outside its published count")
    if conf["q_lora_rank"] is not None or conf["routed_scaling_factor"] != 1 \
            or conf["scoring_func"] != "softmax" or conf["topk_method"] != "greedy":
        raise ValueError(f"{name}: the port runs no q-LoRA, no routed "
                         "scaling and greedy softmax routing only")
    config(conf)


def reference_weights(params) -> dict:
    """The reference's weight dict for the port's ``LM`` ``params``: the
    masters themselves (no copy), so that the reference's gradients land
    on their ``.grad``."""
    named = dict(params.named_parameters())

    def block(prefix, mod):
        w = {k: named[f"{prefix}.{name}"] for k, name in (
            ("norm1", "norm1.scale"), ("norm2", "norm2.scale"),
            ("wq", "attn.wq.weight"), ("wkv_a", "attn.wkv_a.weight"),
            ("kv_norm", "attn.kv_norm.scale"), ("wkv_b", "attn.wkv_b.weight"),
            ("wo", "attn.wo.weight"))}
        if hasattr(mod, "moe"):
            w["router"] = named[f"{prefix}.moe.router"]
            w["experts"] = {k: named[f"{prefix}.moe.{k}"]
                            for k in ("w_gate", "w_up", "w_down")}
            w["shared"] = {k: named[f"{prefix}.moe.shared.{k}.weight"]
                           for k in ("w_gate", "w_up", "w_down")}
        else:
            w["mlp"] = {k: named[f"{prefix}.mlp.{k}.weight"]
                        for k in ("w_gate", "w_up", "w_down")}
        return w

    layers = [block(f"head.{i}", m) for i, m in enumerate(params.head)]
    for j, group in enumerate(params.layers):
        for key, m in group.items():
            layers.append(block(f"layers.{j}.{key}", m))
    return {"embed": named["embed.tokens"], "lm_head": named["lm_head.weight"],
            "final_norm": named["final_norm.scale"], "layers": layers}


@contextlib.contextmanager
def _patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def mode(kind: str, which: str):
    """The program's path as ``which`` says (``program``, ``control`` or one
    of ``FAULTS``), for the block, in a cell of traffic kind ``kind``."""
    import dataclasses

    import torch

    from repro_torch import steps
    from repro_torch.models import attention, moe
    from repro_torch.optim import adamw

    from tmbench import harness

    if which == "program":
        yield
        return
    if which == "control":
        traffic = harness.kind_module(kind)
        with _patched(traffic, "program_side", traffic.control_side):
            yield
        return
    if which == "rope_dropped":
        rope = attention.mla_rope

        def unrotated_key(cfg, t, positions):
            return t if t.shape[2] == 1 else rope(cfg, t, positions)
        with _patched(attention, "mla_rope", unrotated_key):
            yield
        return
    if which == "latent_unnormed":
        def unnormed(p, cfg, x, positions):
            c, k_r = attention._proj(p.wkv_a, x).split(
                [cfg.kv_lora_rank, cfg.qk_rope_head_dim], -1)
            return c, attention.mla_rope(cfg, k_r[:, :, None], positions)[:, :, 0]
        with _patched(attention, "mla_latent", unnormed):
            yield
        return
    if which == "softmax_unscaled":
        with _patched(attention, "mla_scale",
                      lambda cfg: cfg.qk_head_dim ** -0.5):
            yield
        return
    if which == "shared_gated":
        shared = moe.shared_out

        def gated(p, x, *, act="silu"):
            gate = torch.sigmoid(x @ p.router[:, :1].to(x.dtype))
            return gate * shared(p, x, act=act)
        with _patched(moe, "shared_out", gated):
            yield
        return
    if which == "step_skipped":
        def unchanged(grads, state, params, *, lr, **_):
            return (adamw.AdamWState(state.step + 1, state.mu, state.nu),
                    {"grad_norm": adamw.global_norm(grads), "lr": lr})
        with _patched(adamw, "update", unchanged):
            yield
        return
    if which == "half_batch":
        make = steps.make_step

        def halved(cfg, shape, mesh=None, **kw):
            m = kw["microbatches"]
            build = make(cfg, dataclasses.replace(
                shape, global_batch=shape.global_batch // 2), mesh,
                **{**kw, "microbatches": max(1, m // 2)})

            def fn(state, batch):
                return build.fn(state, {k: v[:v.shape[0] // 2]
                                        for k, v in batch.items()})
            return dataclasses.replace(build, fn=fn)
        with _patched(steps, "make_step", halved):
            yield
        return
    raise ValueError(f"mode {which!r}: one of program, control, {FAULTS}")
