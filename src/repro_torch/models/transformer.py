"""Decoder-only LM assembly for the dense and VLM families (the port's
``repro.models.transformer``).

The layer stack is an ``nn.ModuleList`` of groups walked in Python; each
group is an ``nn.ModuleDict`` keyed ``b{i}_{kind}`` as the reference's
stacked params are, so ``layers[j]["b0_attn_mlp"]`` is layer ``j`` of a
dense model. Caches keep the reference's stacked layout,
``{"layers": {"b0_attn_mlp": {"k": (L, B, Hkv, S, Dh), "v": …, "pos":
(L, B, S)}}}``; prefill fills a fresh one and ``decode_step`` updates the
cache it is given in place (each layer writes through a view of its slice)
and returns it.

API (functions of the config and an ``LM`` module):
  init_params(gen, cfg)                       → LM
  apply_train(cfg, params, tokens, …)         → (logits, aux)
  prefill(cfg, params, tokens, cache_len, …)  → (logits_last, cache)
  decode_step(cfg, params, token, cache, pos) → (logits, cache)
  init_cache(cfg, batch, cache_len, …)        → cache

The MoE (``attn_moe``), RWKV (``rwkv``) and Griffin (``rec_mlp``) blocks
come with later slices; ``_plan`` and ``_init_block`` raise
``NotImplementedError`` for them.
"""
from __future__ import annotations

import functools

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.types import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import (
    Embed,
    LayerNorm,
    RMSNorm,
    embed,
    empty_linear,
    init_linear_,
    layernorm,
    rmsnorm,
    truncated_normal_,
    unembed,
)
from repro_torch.models.mlp import MLP, init_mlp, mlp

COMPUTE_DTYPE = torch.bfloat16

_LATER = {
    "moe": "the MoE slice (models/moe.py)",
    "ssm": "the recurrent slice (models/recurrence.py, models/rwkv6.py)",
    "hybrid": "the recurrent slice (models/recurrence.py, models/griffin.py)",
    "encdec": "the encoder-decoder slice (models/whisper.py)",
}
_KIND_FAMILY = {"attn_moe": "moe", "rwkv": "ssm", "rec_mlp": "hybrid"}


def not_ported(family: str) -> NotImplementedError:
    """The error for a family whose layers a later slice of the port brings."""
    return NotImplementedError(
        f"the {family!r} family is not ported yet: it comes with "
        f"{_LATER[family]}; the port runs the dense and vlm families")


def _norm_fns(cfg):
    if cfg.norm == "layernorm":
        return LayerNorm, functools.partial(layernorm, eps=cfg.norm_eps)
    return RMSNorm, functools.partial(rmsnorm, eps=cfg.norm_eps)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


class AttnBlock(nn.Module):
    """Pre-norm attention + MLP block (``attn_mlp``): ``norm1``, ``attn``,
    ``norm2``, ``mlp``; the norms start at ones (and zeros)."""

    def __init__(self, cfg: ModelConfig, attn: attn_mod.Attention, mlp_: MLP):
        super().__init__()
        norm_cls, _ = _norm_fns(cfg)
        device = attn.wq.weight.device
        self.norm1 = norm_cls(cfg.d_model, device)
        self.norm2 = norm_cls(cfg.d_model, device)
        self.attn = attn
        self.mlp = mlp_


def _empty_attn_block(cfg: ModelConfig, device) -> AttnBlock:
    return AttnBlock(cfg, attn_mod.Attention(
        cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_,
        qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm, device=device),
        MLP(cfg.d_model, cfg.d_ff, gated=(cfg.act == "silu"), device=device))


def _init_attn_block(gen: torch.Generator, cfg: ModelConfig, *,
                     mixer: str) -> AttnBlock:
    """mixer: 'mlp' (the 'moe' mixer comes with the MoE slice)."""
    if mixer != "mlp":
        raise not_ported("moe")
    return AttnBlock(cfg, attn_mod.init_attention(
        gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_,
        qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm),
        init_mlp(gen, cfg.d_model, cfg.d_ff, gated=(cfg.act == "silu")))


def _attn_block_seq(p: AttnBlock, cfg, x, positions, cache, *, window,
                    decode=False):
    """Returns (x, cache). ``cache`` is None in training; in prefill the
    returned cache is a new one built from this pass's K/V."""
    _, norm = _norm_fns(cfg)
    h = norm(p.norm1, x)
    if decode:
        o, cache = attn_mod.decode_attend(
            p.attn, h, cache, positions, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim_,
            rope_theta=cfg.rope_theta, window=window)
    else:
        o, (k, v) = attn_mod.attend(
            p.attn, h, positions, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim_,
            rope_theta=cfg.rope_theta, kind="causal", window=window,
            dense_max_seq=cfg.dense_attn_max, kv_block=cfg.kv_block)
        if cache is not None:
            cache = attn_mod.cache_from_prefill(k, v, positions,
                                                cache["k"].shape[2])
    x = x + o
    h = norm(p.norm2, x)
    return x + mlp(p.mlp, h, act=cfg.act), cache


# ---------------------------------------------------------------------------
# Layer-stack plan per family
# ---------------------------------------------------------------------------


def _plan(cfg: ModelConfig):
    """(group_kinds, n_groups, tail_kinds): the block kinds of one group, how
    many times the group repeats, and unrolled trailing blocks (none for
    the dense and vlm families)."""
    if cfg.family in ("dense", "vlm"):
        return ("attn_mlp",), cfg.n_layers, ()
    if cfg.family in _LATER:
        raise not_ported(cfg.family)
    raise ValueError(cfg.family)


def _init_block(gen, cfg, kind):
    if kind == "attn_mlp":
        return _init_attn_block(gen, cfg, mixer="mlp")
    if kind in _KIND_FAMILY:
        raise not_ported(_KIND_FAMILY[kind])
    raise ValueError(kind)


class LM(nn.Module):
    """``embed``, ``layers`` (groups of blocks), ``final_norm`` and, unless
    the embeddings are tied, ``lm_head`` (``nn.Linear``, weight (V, d)).
    Built with uninitialised weights (``convert.lm_params_from_reference``
    copies them in) unless ``make_block(kind)`` supplies the blocks, as
    ``init_params`` does."""

    def __init__(self, cfg: ModelConfig, device=None, make_block=None):
        super().__init__()
        kinds, n_groups, _ = _plan(cfg)
        make_block = make_block or (lambda kind: _empty_attn_block(cfg, device))
        norm_cls, _ = _norm_fns(cfg)
        self.embed = Embed(cfg.vocab, cfg.d_model, device)
        self.layers = nn.ModuleList(
            nn.ModuleDict({f"b{i}_{kind}": make_block(kind)
                           for i, kind in enumerate(kinds)})
            for _ in range(n_groups))
        self.final_norm = norm_cls(cfg.d_model, device)
        self.lm_head = (None if cfg.tie_embeddings else
                        empty_linear(cfg.d_model, cfg.vocab, device=device))


@torch.no_grad()
def init_params(gen: torch.Generator, cfg: ModelConfig) -> LM:
    """Random float32 weights on ``gen.device``, drawn from ``gen`` in
    place (no second copy of any tensor)."""
    params = LM(cfg, gen.device,
                make_block=lambda kind: _init_block(gen, cfg, kind))
    truncated_normal_(params.embed.tokens, gen, 1.0)
    if params.lm_head is not None:
        init_linear_(gen, params.lm_head)
    return params


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def cache_shapes(cfg: ModelConfig, batch: int, cache_len: int,
                 dtype=torch.bfloat16) -> dict:
    """The stacked cache's ``(shape, dtype)`` per tensor, allocating nothing."""
    kinds, n_groups, _ = _plan(cfg)
    out = {}
    window = cfg.sliding_window       # hybrid's local window: recurrent slice
    clen = min(cache_len, window) if window else cache_len
    for i, kind in enumerate(kinds):
        kv = (n_groups, batch, cfg.n_kv_heads, clen, cfg.head_dim_)
        out[f"b{i}_{kind}"] = {"k": (kv, dtype), "v": (kv, dtype),
                               "pos": ((n_groups, batch, clen), torch.int32)}
    return {"layers": out}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """An empty stacked cache (K/V zeros, ``pos`` -1) on ``device``."""
    dev = resolve_device(device)
    return {"layers": {
        key: {name: (torch.full(shape, -1, dtype=dt, device=dev)
                     if name == "pos" else
                     torch.zeros(shape, dtype=dt, device=dev))
              for name, (shape, dt) in block.items()}
        for key, block in cache_shapes(cfg, batch, cache_len,
                                       dtype)["layers"].items()}}


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _run_stack(cfg, params: LM, x, positions, caches, decode):
    """Walk the layer stack; returns (x, caches, aux). With ``caches``, each
    layer reads and writes its slice of the stacked tensors in place."""
    kinds, _, _ = _plan(cfg)
    for j, group in enumerate(params.layers):
        for i, kind in enumerate(kinds):
            key = f"b{i}_{kind}"
            layer_cache = None
            if caches is not None:
                layer_cache = {name: t[j]
                               for name, t in caches["layers"][key].items()}
            x, new_cache = _attn_block_seq(
                group[key], cfg, x, positions, layer_cache,
                window=cfg.sliding_window, decode=decode)
            if layer_cache is not None and new_cache is not layer_cache:
                for name, t in layer_cache.items():
                    t.copy_(new_cache[name])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, caches, aux


def _embed_inputs(cfg, params: LM, tokens, vision_embeds=None):
    x = embed(params.embed, tokens, COMPUTE_DTYPE)
    if cfg.family == "vlm" and vision_embeds is not None:
        x = torch.cat([vision_embeds.to(COMPUTE_DTYPE), x], dim=1)
    return x


def _logits(cfg, params: LM, x):
    _, norm = _norm_fns(cfg)
    return unembed(params.embed, params.lm_head, norm(params.final_norm, x))


def apply_train(cfg: ModelConfig, params: LM, tokens, vision_embeds=None):
    """tokens: (B, S_text) int → (logits (B, S, V) float32, aux). A forward
    pass with autograd on (the training slice builds on it)."""
    x = _embed_inputs(cfg, params, tokens, vision_embeds)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, _, aux = _run_stack(cfg, params, x, positions, None, decode=False)
    return _logits(cfg, params, x).float(), aux


@torch.no_grad()
def prefill(cfg: ModelConfig, params: LM, tokens, cache_len,
            vision_embeds=None):
    """Full-sequence inference producing the KV cache (in the compute
    dtype, as the reference's prefill returns it).

    Returns (last-position logits (B, V) float32, caches)."""
    x = _embed_inputs(cfg, params, tokens, vision_embeds)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None, :]
    caches = init_cache(cfg, b, cache_len, dtype=x.dtype, device=x.device)
    x, caches, _ = _run_stack(cfg, params, x, positions, caches, decode=False)
    logits = _logits(cfg, params, x[:, -1:])
    return logits[:, 0].float(), caches


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: LM, token, caches, pos):
    """token: (B, 1) int; pos: (B,) absolute positions. Updates ``caches``
    in place. Returns (logits (B, V) float32, caches)."""
    x = embed(params.embed, token, COMPUTE_DTYPE)
    x, caches, _ = _run_stack(cfg, params, x, pos[:, None], caches,
                              decode=True)
    return _logits(cfg, params, x)[:, 0].float(), caches
