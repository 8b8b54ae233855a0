"""Decoder-only LM assembly: the dense, moe, vlm, ssm and hybrid families
(the port's ``repro.models.transformer``; the encoder-decoder family is
``models/whisper.py``).

The layer stack is an ``nn.ModuleList`` of groups walked in Python; each
group is an ``nn.ModuleDict`` keyed ``b{i}_{kind}`` as the reference's
stacked params are, so ``layers[j]["b0_attn_mlp"]`` is layer ``j`` of a
dense model. A hybrid depth that the pattern does not divide ends in
``tail``, unrolled blocks (recurrentgemma-9b: 12 groups of (rec, rec,
attn) and 2 trailing rec blocks). Caches keep the reference's layout,
``{"layers": {"b0_attn_mlp": {"k": (L, B, Hkv, S, Dh), "v": …, "pos":
(L, B, S)}, …}, "tail": [{…}, …]}`` (``tail`` only where the plan has
one); prefill fills a fresh one and ``decode_step`` updates the cache it
is given in place (each layer writes through a view of its slice) and
returns it.

Block kinds: ``attn_mlp`` and ``attn_moe`` (attention with an MLP or a
MoE mixer), ``rwkv`` (RWKV-6), ``rec_mlp`` (a Griffin recurrent block
and an MLP).

An attention block's attention, cache layout and sharded path are its
config's attention kind's (``attention.kind_of``: GQA, or DeepSeek-V2's
MLA with its latent cache). A MoE config's ``n_dense_layers`` leading
``attn_mlp`` blocks lie in ``head``, unrolled like ``tail`` (empty for
every config but DeepSeek-V2's).

On a mesh (``*_sharded``: an active ``Policy`` and a ``ShardedModule``
or its per-rank views; activations, caches and tokens as ``PerRank``
lists) the stack runs every block kind, the tail too, in the Megatron
partition the parameter specs imply. Each rank runs the single-device
functions on its slice: a block's weights are gathered over ``data``
just before use (FSDP) and dropped after; q/k/v, gate/up, RWKV-6's
heads, Griffin's d_rnn channels and the vocabulary are split over
``model``, and ``wo`` / ``w_down`` / RWKV-6's ``w_o`` and ``cm/w_v`` /
Griffin's ``w_o`` are row-parallel, reduced over ``model``
(``models/rwkv6.py`` and ``models/griffin.py`` say where their states
move). When ``policy.sequence_split`` holds, the residual lies split on
the sequence over ``model`` between blocks: reduce-scatter after a
row-parallel product, all-gather before the next column-parallel one.

API (functions of the config and an ``LM`` module):
  init_params(gen, cfg)                       → LM
  apply_train(cfg, params, tokens, …)         → (logits, aux)
  prefill(cfg, params, tokens, cache_len, …)  → (logits_last, cache)
  decode_step(cfg, params, token, cache, pos) → (logits, cache)
  init_cache(cfg, batch, cache_len, …)        → cache
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.types import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import griffin as griffin_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.launch.mesh import axis_index, axis_size
from repro_torch.models.common import (
    Embed,
    LayerNorm,
    RMSNorm,
    embed,
    embed_sharded,
    empty_linear,
    init_linear_,
    layernorm,
    linear_f32,
    norm_split,
    rmsnorm,
    truncated_normal_,
    unembed,
)
from repro_torch.models.mlp import MLP, init_mlp, mlp, mlp_sharded, mlp_stationary
from repro_torch.models.moe import MoE, init_moe, moe_block
from repro_torch.spans import span
from repro_torch.sharding import (
    DATA,
    MODEL,
    PerRank,
    ShardedModule,
    all_gather,
    batch_to_stationary,
    cache_partition_specs,
    gather_batch,
    gather_params,
    local_structs,
    param_specs,
    psum,
    psum_scatter,
    psum_to_batch,
    stationary_to_batch,
)

COMPUTE_DTYPE = torch.bfloat16


def _norm_fns(cfg):
    if cfg.norm == "layernorm":
        return LayerNorm, functools.partial(layernorm, eps=cfg.norm_eps)
    return RMSNorm, functools.partial(rmsnorm, eps=cfg.norm_eps)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


class AttnBlock(nn.Module):
    """Pre-norm attention block: ``norm1``, ``attn``, ``norm2`` and its
    mixer, ``mlp`` (``attn_mlp``) or ``moe`` (``attn_moe``); the norms
    start at ones (and zeros)."""

    def __init__(self, cfg: ModelConfig, attn: nn.Module, mixer: nn.Module):
        super().__init__()
        norm_cls, _ = _norm_fns(cfg)
        device = attn.wq.weight.device
        self.norm1 = norm_cls(cfg.d_model, device)
        self.norm2 = norm_cls(cfg.d_model, device)
        self.attn = attn
        if isinstance(mixer, MoE):
            self.moe = mixer
        else:
            self.mlp = mixer


class RecBlock(nn.Module):
    """Griffin's ``rec_mlp``: ``norm1``, ``rec`` (a ``RecurrentBlock``),
    ``norm2``, ``mlp`` (gated)."""

    def __init__(self, cfg: ModelConfig, rec: griffin_mod.RecurrentBlock,
                 mlp_: MLP):
        super().__init__()
        norm_cls, _ = _norm_fns(cfg)
        device = rec.w_y.weight.device
        self.norm1 = norm_cls(cfg.d_model, device)
        self.norm2 = norm_cls(cfg.d_model, device)
        self.rec = rec
        self.mlp = mlp_


def _moe_kw(cfg: ModelConfig) -> dict:
    """``MoE`` / ``init_moe`` arguments: widths, experts held and shared,
    the shared experts' gate."""
    return dict(d_model=cfg.d_model, d_ff_expert=cfg.d_ff_expert or cfg.d_ff,
                n_experts=cfg.n_experts, n_held=cfg.n_held,
                n_shared=cfg.n_shared_experts, d_ff_shared=cfg.d_ff_shared,
                shared_gate=cfg.shared_gate)


def _empty_block(cfg: ModelConfig, kind: str, device) -> nn.Module:
    """A block of ``kind`` with uninitialised weights."""
    if kind in ("attn_mlp", "attn_moe"):
        attn = attn_mod.kind_of(cfg).empty(cfg, device)
        if kind == "attn_moe":
            return AttnBlock(cfg, attn, MoE(device=device, **_moe_kw(cfg)))
        return AttnBlock(cfg, attn, MLP(cfg.d_model, cfg.d_ff,
                                        gated=(cfg.act == "silu"),
                                        device=device))
    if kind == "rwkv":
        return rwkv_mod.RWKVBlock(cfg.d_model, cfg.d_ff, cfg.rwkv_heads,
                                  cfg.rwkv_head_dim, device)
    if kind == "rec_mlp":
        return RecBlock(cfg, griffin_mod.RecurrentBlock(
            cfg.d_model, cfg.d_rnn or cfg.d_model, device),
            MLP(cfg.d_model, cfg.d_ff, gated=True, device=device))
    raise ValueError(kind)


def _init_block(gen, cfg, kind):
    if kind in ("attn_mlp", "attn_moe"):
        attn = attn_mod.kind_of(cfg).init(gen, cfg)
        if kind == "attn_moe":
            return AttnBlock(cfg, attn, init_moe(gen, **_moe_kw(cfg)))
        return AttnBlock(cfg, attn, init_mlp(gen, cfg.d_model, cfg.d_ff,
                                             gated=(cfg.act == "silu")))
    if kind == "rwkv":
        return rwkv_mod.init_rwkv_block(gen, cfg.d_model, cfg.d_ff,
                                        cfg.rwkv_heads, cfg.rwkv_head_dim)
    if kind == "rec_mlp":
        return RecBlock(cfg, griffin_mod.init_recurrent_block(
            gen, cfg.d_model, cfg.d_rnn or cfg.d_model),
            init_mlp(gen, cfg.d_model, cfg.d_ff, gated=True))
    raise ValueError(kind)


def _attn_block_seq(p: AttnBlock, cfg, x, positions, cache, *, decode=False):
    """Returns (x, cache, aux). ``cache`` is None in training; in prefill
    the returned cache is a new one built from this pass (the config's
    attention kind's layout)."""
    _, norm = _norm_fns(cfg)
    h = norm(p.norm1, x)
    attn = attn_mod.kind_of(cfg)
    if decode:
        o, cache = attn.decode(p.attn, cfg, h, cache, positions)
    else:
        o, cache = attn.seq(p.attn, cfg, h, positions, cache)
    x = x + o
    h = norm(p.norm2, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if hasattr(p, "moe"):
        # inference (prefill and decode) is dropless, so both cache paths
        # route alike; training keeps the capacity drops
        o, aux = moe_block(
            p.moe, h, top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
            act=cfg.act, dispatch=cfg.moe_dispatch,
            normalize=cfg.normalize_topk,
            dropless=decode or cache is not None)
    else:
        with span("lm.mlp"):
            o = mlp(p.mlp, h, act=cfg.act)
    return x + o, cache, aux


def _rec_block_seq(p: RecBlock, cfg, x, state, *, decode=False):
    _, norm = _norm_fns(cfg)
    h = norm(p.norm1, x)
    if decode:
        o, state = griffin_mod.recurrent_block_step(p.rec, h[:, 0], state)
        o = o[:, None]
    else:
        o, state = griffin_mod.recurrent_block_seq(p.rec, h, state,
                                                   chunk=cfg.rnn_chunk)
    x = x + o
    return x + mlp(p.mlp, norm(p.norm2, x), act=cfg.act), state


# ---------------------------------------------------------------------------
# Layer-stack plan per family
# ---------------------------------------------------------------------------


def _plan(cfg: ModelConfig):
    """(head_kinds, group_kinds, n_groups, tail_kinds): unrolled leading
    blocks (a MoE config's ``n_dense_layers`` dense ones), the block kinds
    of one group, how many times the group repeats, and unrolled trailing
    blocks (a hybrid depth the pattern does not divide)."""
    if cfg.family in ("dense", "vlm"):
        return (), ("attn_mlp",), cfg.n_layers, ()
    if cfg.family == "moe":
        return (("attn_mlp",) * cfg.n_dense_layers, ("attn_moe",),
                cfg.n_layers - cfg.n_dense_layers, ())
    if cfg.family == "ssm":
        return (), ("rwkv",), cfg.n_layers, ()
    if cfg.family == "hybrid":
        pat = cfg.pattern or ("rec", "rec", "attn")
        kinds = tuple("attn_mlp" if k == "attn" else "rec_mlp" for k in pat)
        n = cfg.n_layers // len(pat)
        return (), kinds, n, kinds[:cfg.n_layers - n * len(pat)]
    raise ValueError(f"{cfg.family!r}: not a decoder-only family (the "
                     "encoder-decoder family is models/whisper.py)")


class LM(nn.Module):
    """``embed``, ``head`` (leading blocks, the config's ``n_dense_layers``;
    mostly empty), ``layers`` (groups of blocks), ``tail`` (trailing blocks,
    empty unless the plan has some), ``final_norm`` and, unless the
    embeddings are tied, ``lm_head`` (``nn.Linear``, weight (V, d)). Built
    with uninitialised weights (``convert.lm_params_from_reference`` copies
    them in) unless ``make_block(kind)`` supplies the blocks, as
    ``init_params`` does."""

    def __init__(self, cfg: ModelConfig, device=None, make_block=None):
        super().__init__()
        head, kinds, n_groups, tail = _plan(cfg)
        make_block = make_block or (lambda kind: _empty_block(cfg, kind, device))
        norm_cls, _ = _norm_fns(cfg)
        self.embed = Embed(cfg.vocab, cfg.d_model, device)
        self.head = nn.ModuleList(make_block(kind) for kind in head)
        self.layers = nn.ModuleList(
            nn.ModuleDict({f"b{i}_{kind}": make_block(kind)
                           for i, kind in enumerate(kinds)})
            for _ in range(n_groups))
        self.tail = nn.ModuleList(make_block(kind) for kind in tail)
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
# Caches and recurrent state
# ---------------------------------------------------------------------------


def _block_cache_shapes(cfg: ModelConfig, kind: str, batch: int,
                        cache_len: int, dtype) -> dict:
    """One block's cache as ``{name: (shape, dtype)}``. ``dtype`` is that
    of the K/V cache and of RWKV's token shifts; RWKV's ``wkv`` and
    Griffin's state are float32."""
    if kind in ("attn_mlp", "attn_moe"):
        return attn_mod.kind_of(cfg).cache_shapes(cfg, batch, cache_len, dtype)
    if kind == "rwkv":
        return rwkv_mod.rwkv_state_shapes(batch, cfg.d_model, cfg.rwkv_heads,
                                          cfg.rwkv_head_dim, dtype)
    if kind == "rec_mlp":
        return griffin_mod.griffin_state_shapes(batch, cfg.d_rnn or cfg.d_model)
    raise ValueError(kind)


def cache_shapes(cfg: ModelConfig, batch: int, cache_len: int,
                 dtype=torch.bfloat16) -> dict:
    """The cache's ``(shape, dtype)`` per tensor, allocating nothing: the
    groups' blocks stacked ``(n_groups, …)`` under ``layers``, the tail's
    (and the head's) unstacked under ``tail`` (``head``). With
    the default bf16 it is the reference's ``init_cache``."""
    head, kinds, n_groups, tail = _plan(cfg)
    out = {"layers": {
        f"b{i}_{kind}": {name: ((n_groups,) + shape, dt) for name, (shape, dt)
                         in _block_cache_shapes(cfg, kind, batch, cache_len,
                                                dtype).items()}
        for i, kind in enumerate(kinds)}}
    if tail:
        out["tail"] = [_block_cache_shapes(cfg, kind, batch, cache_len, dtype)
                       for kind in tail]
    if head:
        out["head"] = [_block_cache_shapes(cfg, kind, batch, cache_len, dtype)
                       for kind in head]
    return out


def _alloc(block: dict, dev) -> dict:
    """Tensors for one block's ``{name: (shape, dtype)}``: zeros, ``pos``
    -1 (empty slots)."""
    return {name: (torch.full(shape, -1, dtype=dt, device=dev) if name == "pos"
                   else torch.zeros(shape, dtype=dt, device=dev))
            for name, (shape, dt) in block.items()}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """An empty cache on ``device`` (see ``cache_shapes`` for the dtypes)."""
    dev = resolve_device(device)
    shapes = cache_shapes(cfg, batch, cache_len, dtype)
    out = {"layers": {key: _alloc(block, dev)
                      for key, block in shapes["layers"].items()}}
    for part in ("tail", "head"):
        if part in shapes:
            out[part] = [_alloc(block, dev) for block in shapes[part]]
    return out


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _apply_block(p, cfg, kind, x, positions, cache, decode):
    """One block; returns (x, new_cache, aux). A recurrent block in
    training (``cache`` None) starts from a zero state."""
    if kind in ("attn_mlp", "attn_moe"):
        return _attn_block_seq(p, cfg, x, positions, cache, decode=decode)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "rwkv":
        if cache is None:
            cache = rwkv_mod.init_rwkv_state(
                x.shape[0], cfg.d_model, cfg.rwkv_heads, cfg.rwkv_head_dim,
                device=x.device)
        kw = dict(n_heads=cfg.rwkv_heads, head_dim=cfg.rwkv_head_dim)
        if decode:
            x, state = rwkv_mod.rwkv_block_step(p, x[:, 0], cache, **kw)
            return x[:, None], state, aux
        x, state = rwkv_mod.rwkv_block_seq(p, x, cache, chunk=cfg.rwkv_chunk,
                                           **kw)
        return x, state, aux
    if kind == "rec_mlp":
        if cache is None:
            cache = griffin_mod.init_griffin_state(
                x.shape[0], cfg.d_rnn or cfg.d_model, device=x.device)
        x, state = _rec_block_seq(p, cfg, x, cache, decode=decode)
        return x, state, aux
    raise ValueError(kind)


def _store(cache: dict, new: dict) -> None:
    """Write a block's new cache into its slot, in place, cast to the
    slot's dtypes (the reference's ``n.astype(c.dtype)``)."""
    if new is not cache:
        for name, t in cache.items():
            t.copy_(new[name])


def _train_group(group, cfg, kinds, x, positions):
    """One group of blocks without caches; returns (x, aux of the group)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, kind in enumerate(kinds):
        x, _, a = _apply_block(group[f"b{i}_{kind}"], cfg, kind, x, positions,
                               None, False)
        aux = aux + a
    return x, aux


def maybe_checkpoint(fn, cfg, *args):
    """``fn(*args)``, recomputed in the backward pass
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``) when
    ``cfg.remat`` is set and autograd is on; a plain call otherwise."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _run_stack(cfg, params: LM, x, positions, caches, decode):
    """Walk the layer stack and the tail; returns (x, caches, aux summed
    over the blocks). With ``caches``, each block reads and writes its
    slice of the cache in place. In training (no caches) each head block and
    each group goes through ``maybe_checkpoint``; the tail is not
    recomputed."""
    head, kinds, _, tail = _plan(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, kind in enumerate(head):
        if caches is None:
            x, a = maybe_checkpoint(_train_group, cfg,
                                    {f"b0_{kind}": params.head[i]}, cfg,
                                    (kind,), x, positions)
        else:
            cache = caches["head"][i]
            x, new, a = _apply_block(params.head[i], cfg, kind, x, positions,
                                     cache, decode)
            _store(cache, new)
        aux = aux + a
    if caches is None:
        for group in params.layers:
            x, a = maybe_checkpoint(_train_group, cfg, group, cfg, kinds, x,
                                    positions)
            aux = aux + a
    else:
        for j, group in enumerate(params.layers):
            for i, kind in enumerate(kinds):
                key = f"b{i}_{kind}"
                cache = {name: t[j] for name, t in caches["layers"][key].items()}
                x, new, a = _apply_block(group[key], cfg, kind, x, positions,
                                         cache, decode)
                _store(cache, new)
                aux = aux + a
    for i, kind in enumerate(tail):
        cache = None if caches is None else caches["tail"][i]
        x, new, a = _apply_block(params.tail[i], cfg, kind, x, positions,
                                 cache, decode)
        if cache is not None:
            _store(cache, new)
        aux = aux + a
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
    """tokens: (B, S_text) int → (logits (B, S, V) float32, aux), aux the
    Switch load-balance loss summed over the MoE blocks (0 without). A
    forward pass with autograd on (the training slice builds on it)."""
    with span("lm.embed"):
        x = _embed_inputs(cfg, params, tokens, vision_embeds)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, _, aux = _run_stack(cfg, params, x, positions, None, decode=False)
    with span("lm.head_loss"):
        return _logits(cfg, params, x).float(), aux


@torch.no_grad()
def prefill(cfg: ModelConfig, params: LM, tokens, cache_len,
            vision_embeds=None):
    """Full-sequence inference producing the cache (K/V and token shifts in
    the compute dtype, as the reference's prefill returns them; recurrent
    states float32).

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


# ---------------------------------------------------------------------------
# The sharded stack (a mesh: per-rank lists)
# ---------------------------------------------------------------------------

_ENGINE_PARAMS = ("moe.router", "moe.w_gate", "moe.w_up", "moe.w_down")


def rank_views(params, dtype=None) -> list:
    """Per-rank module views of a ``ShardedModule`` (float32 shards cast to
    ``dtype`` when given), or ``params`` itself when it is already a list
    of them."""
    if isinstance(params, ShardedModule):
        return [params.rank_view(r, dtype) for r in range(params.mesh.size)]
    return list(params)


def _reduce_model(ys, mesh, sp: bool):
    """Row-parallel partial sums reduced over ``model``: a reduce-scatter
    on the sequence when the residual is split (``sp``), else a psum."""
    if sp:
        return psum_scatter(ys, mesh, MODEL, 1)
    return psum(ys, mesh, MODEL)


def _seq_chunk(xs, mesh):
    """Each rank's chunk of the sequence (dim 1) by its ``model`` index,
    of a tensor replicated over ``model`` (no communication)."""
    m = axis_size(mesh, MODEL)
    return PerRank(x.chunk(m, dim=1)[axis_index(mesh, r, MODEL)]
                   for r, x in enumerate(xs))


def _attn_sharded(ps, cfg, policy, xs, positions, caches, *, decode, sp,
                  kind="causal", kv_block=None):
    """The attention half of a block on every rank: ``norm1``, head-parallel
    attention (``ps[r]`` rank r's block, gathered over ``data``), the
    reduction of ``wo``, the residual. ``sp``: the residual is split on
    the sequence (never in decode). With ``caches`` (per-rank dicts),
    prefill writes each rank's slice of the K/V and decode updates it in
    place. Returns (xs, caches)."""
    mesh = policy.mesh
    _, norm = _norm_fns(cfg)
    m = axis_size(mesh, MODEL)
    hs = [norm(p.norm1, x) for p, x in zip(ps, xs)]
    kw = dict(mesh=mesh, **attn_mod.gqa_kw(cfg))
    if decode:
        ys, caches = attn_mod.decode_attend_sharded(
            [p.attn for p in ps], hs, caches, positions, **kw)
    else:
        if sp:
            hs = all_gather(hs, mesh, MODEL, 1)
        ys, kvs = attn_mod.attend_sharded(
            [p.attn for p in ps], hs, positions, kind=kind,
            dense_max_seq=cfg.dense_attn_max,
            kv_block=cfg.kv_block if kv_block is None else kv_block, **kw)
        if caches is not None:
            ks = attn_mod.gather_kv_heads([k for k, _ in kvs], mesh,
                                          cfg.n_heads, cfg.n_kv_heads, 2)
            vs = attn_mod.gather_kv_heads([v for _, v in kvs], mesh,
                                          cfg.n_heads, cfg.n_kv_heads, 2)
            for r, cache in enumerate(caches):
                s_local = cache["k"].shape[2]
                full = attn_mod.cache_from_prefill(
                    ks[r], vs[r], positions.to(ks[r].device), s_local * m)
                lo = axis_index(mesh, r, MODEL) * s_local
                for name, t in cache.items():
                    t.copy_(full[name][..., lo:lo + s_local, :] if name != "pos"
                            else full[name][:, lo:lo + s_local])
    return [x + y.to(x.dtype)
            for x, y in zip(xs, _reduce_model(ys, mesh, sp))], caches


def _mixer_sharded(ps, cfg, policy, xs, *, sp, dropless=True):
    """The mixer half of a block on every rank: ``norm2``, the
    tensor-parallel MLP (or the MoE's engine, ``dropless`` in inference),
    the residual. Returns (xs, aux per rank)."""
    mesh = policy.mesh
    _, norm = _norm_fns(cfg)
    hs = [norm(p.norm2, x) for p, x in zip(ps, xs)]
    if sp:
        hs = all_gather(hs, mesh, MODEL, 1)
    if hasattr(ps[0], "moe"):
        os_, aux = moe_block(
            [p.moe for p in ps], hs, top_k=cfg.top_k,
            capacity_factor=cfg.capacity_factor, act=cfg.act,
            dispatch=cfg.moe_dispatch, normalize=cfg.normalize_topk,
            dropless=dropless, policy=policy)
        if sp:
            os_ = _seq_chunk(os_, mesh)
    else:
        os_ = mlp_sharded([p.mlp for p in ps], hs, act=cfg.act, mesh=mesh,
                          axis=MODEL, scatter_dim=1 if sp else None)
        aux = [torch.zeros((), dtype=torch.float32, device=x.device) for x in xs]
    return [x + o.to(x.dtype) for x, o in zip(xs, os_)], aux


def _rec_block_sharded(blocks, prefix, specs, cfg, policy, kind, xs, states,
                       *, decode, sp):
    """One recurrent block on every rank: RWKV-6 (``rwkv``, its ``ln1`` /
    ``ln2`` inside ``rwkv_block_sharded``) or Griffin's ``rec_mlp`` (norms,
    the recurrent block, the gated MLP). ``states``: per-rank state dicts
    in the stored layout, or None in training. Returns (xs, states)."""
    mesh = policy.mesh
    ps = gather_params(blocks, specs, mesh, prefix)
    if kind == "rwkv":
        return rwkv_mod.rwkv_block_sharded(
            ps, xs, states, mesh=mesh, n_heads=cfg.rwkv_heads,
            head_dim=cfg.rwkv_head_dim, chunk=cfg.rwkv_chunk, decode=decode,
            sp=sp)
    _, norm = _norm_fns(cfg)
    hs = [norm(p.norm1, x) for p, x in zip(ps, xs)]
    if sp:
        hs = all_gather(hs, mesh, MODEL, 1)
    ys, states = griffin_mod.recurrent_block_sharded(
        [p.rec for p in ps], hs, states, mesh=mesh, chunk=cfg.rnn_chunk,
        decode=decode)
    xs = [x + y.to(x.dtype) for x, y in zip(xs, _reduce_model(ys, mesh, sp))]
    xs, _ = _mixer_sharded(ps, cfg, policy, xs, sp=sp)
    return xs, states


# ---------------------------------------------------------------------------
# Weight-stationary decode (``Policy.decode_mode``): the residual is
# (rows, 1, d/|data|) on every rank, d on ``data`` as the reference's
# ``act_residual`` says (the rows those of the rank's batch axes but
# ``data``); each rank contracts its slice with its own weight shards, so only
# activation-sized partial sums move (``sharding.psum_to_batch`` and
# friends). The MoE engine and RWKV-6 keep their gathered weights, as the
# reference's decode program does, and take the residual in the batch
# layout; Griffin gathers its two gate matrices over ``data``.
# ---------------------------------------------------------------------------

_REC_GATES = ("rglru.w_a.weight", "rglru.w_i.weight")


def _norm_stationary(cfg, norms, xs, mesh):
    """``cfg``'s norm of a residual split on d over ``data``."""
    return norm_split(norms, xs, mesh=mesh, axis=DATA, eps=cfg.norm_eps)


def _attn_stationary(blocks, cfg, policy, xs, pos, caches):
    """``norm1``, ``decode_attend_stationary``, the ``wo`` psum over
    ``model`` and the residual."""
    hs = _norm_stationary(cfg, [b.norm1 for b in blocks], xs, policy.mesh)
    ys, _ = attn_mod.decode_attend_stationary(
        [b.attn for b in blocks], hs, caches, pos, policy=policy,
        **attn_mod.gqa_kw(cfg))
    return [x + y.to(x.dtype) for x, y in zip(xs, psum(ys, policy.mesh, MODEL))]


def _mlp_stationary(blocks, cfg, policy, xs):
    """``norm2``, ``mlp_stationary`` and the residual."""
    mesh = policy.mesh
    hs = _norm_stationary(cfg, [b.norm2 for b in blocks], xs, mesh)
    return [x + o.to(x.dtype) for x, o in zip(
        xs, mlp_stationary([b.mlp for b in blocks], hs, act=cfg.act, mesh=mesh))]


def _block_stationary(cfg, policy, specs, blocks, prefix, kind, xs, pos,
                      caches):
    """One block of a weight-stationary decode step on every rank
    (``blocks[r]`` rank r's shards, named under ``prefix``; ``caches`` its
    per-rank cache dicts, written in place). Returns xs."""
    mesh = policy.mesh
    if kind == "rwkv":
        ps = gather_params(blocks, specs, mesh, prefix)
        xb, new = rwkv_mod.rwkv_block_sharded(
            ps, stationary_to_batch(xs, policy), caches, mesh=mesh,
            n_heads=cfg.rwkv_heads, head_dim=cfg.rwkv_head_dim,
            chunk=cfg.rwkv_chunk, decode=True, sp=False)
        for cache, n in zip(caches, new):
            _store(cache, n)
        return batch_to_stationary(xb, policy)
    if kind == "rec_mlp":
        recs = gather_params(
            [b.rec for b in blocks], specs, mesh, prefix + "rec.",
            skip=[n for n, _ in blocks[0].rec.named_parameters()
                  if n not in _REC_GATES])
        hs = _norm_stationary(cfg, [b.norm1 for b in blocks], xs, mesh)
        ys, new = griffin_mod.recurrent_step_stationary(recs, hs, caches,
                                                        policy=policy)
        for cache, n in zip(caches, new):
            _store(cache, n)
        xs = [x + y.to(x.dtype) for x, y in zip(xs, psum(ys, mesh, MODEL))]
        return _mlp_stationary(blocks, cfg, policy, xs)
    xs = _attn_stationary(blocks, cfg, policy, xs, pos, caches)
    if kind == "attn_mlp":
        return _mlp_stationary(blocks, cfg, policy, xs)
    # the MoE engine takes its rows whole, in the batch layout
    _, norm = _norm_fns(cfg)
    xb = stationary_to_batch(xs, policy)
    moes = gather_params([b.moe for b in blocks], specs, mesh, prefix + "moe.",
                         skip=[n.removeprefix("moe.") for n in _ENGINE_PARAMS])
    os_, _ = moe_block(moes, [norm(b.norm2, x) for b, x in zip(blocks, xb)],
                       top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                       act=cfg.act, dispatch=cfg.moe_dispatch,
                       normalize=cfg.normalize_topk, dropless=True,
                       policy=policy)
    return batch_to_stationary([x + o.to(x.dtype) for x, o in zip(xb, os_)],
                               policy)


def _embed_stationary(policy, views, token):
    """The residual's tokens (``gather_batch``) looked up in the rank's
    shard of the table (its vocabulary rows, its ``data`` slice of d), the
    other rows masked, summed over ``model``: (rows, 1, d/|data|)."""
    return embed_sharded([v.embed for v in views], gather_batch(token, policy),
                         mesh=policy.mesh, axis=MODEL,
                         compute_dtype=COMPUTE_DTYPE)


def _logits_stationary(cfg, policy, views, xs, mask=None):
    """The final norm and the head (``lm_head`` or the tied table, each
    (V/|model|, d/|data|) on a rank) on a split residual: the partials are
    summed into the rank's batch rows (``psum_to_batch``) and rounded to
    the compute dtype, as ``unembed``'s product is; ``mask(logits,
    offset)`` then sees the rank's vocabulary slice. Returns (B/|batch|,
    1, V/|model|) in the compute dtype (``_gather_vocab`` casts after its
    gather)."""
    mesh = policy.mesh
    hs = _norm_stationary(cfg, [v.final_norm for v in views], xs, mesh)
    heads = [getattr(v, "lm_head", None) for v in views]
    parts = psum_to_batch([linear_f32(h, v.embed.tokens if lh is None
                                      else lh.weight)
                           for v, lh, h in zip(views, heads, hs)], policy)
    out = [lg.to(h.dtype) for lg, h in zip(parts, hs)]
    if mask is None:
        return out
    return [mask(lg, axis_index(mesh, r, MODEL) * lg.shape[-1])
            for r, lg in enumerate(out)]


def _block_sharded(cfg, policy, specs, blocks, prefix, kind, xs, positions,
                   caches, decode, sp):
    """One block of ``kind`` on every rank (``blocks[r]`` rank r's shards,
    its parameters named under ``prefix``, gathered over ``data`` here and
    dropped after; in a ``decode_mode`` decode step ``_block_stationary``);
    ``caches`` its per-rank cache dicts (written in place) or None.
    Returns (xs, aux per rank)."""
    if decode and policy.decode_mode:
        xs = _block_stationary(cfg, policy, specs, blocks, prefix, kind, xs,
                               positions, caches)
        return xs, [torch.zeros((), dtype=torch.float32, device=x.device)
                    for x in xs]
    if kind in ("attn_mlp", "attn_moe"):
        mesh = policy.mesh
        ps = gather_params(blocks, specs, mesh, prefix, skip=_ENGINE_PARAMS,
                           extra=attn_mod.kv_extra_gather(
                               cfg.n_kv_heads, axis_size(mesh, MODEL), "attn."))
        xs, _ = _attn_sharded(ps, cfg, policy, xs, positions, caches,
                              decode=decode, sp=sp)
        return _mixer_sharded(ps, cfg, policy, xs, sp=sp,
                              dropless=decode or caches is not None)
    xs, new = _rec_block_sharded(blocks, prefix, specs, cfg, policy, kind, xs,
                                 caches, decode=decode, sp=sp)
    if caches is not None:
        for cache, n in zip(caches, new):
            _store(cache, n)
    return xs, [torch.zeros((), dtype=torch.float32, device=x.device)
                for x in xs]


def _run_stack_sharded(cfg, policy, specs, views, xs, positions, caches,
                       decode, sp):
    """The sharded layer walk, then the tail; returns (xs, caches, aux per
    rank). In training each group goes through ``maybe_checkpoint`` (the
    gathers are recomputed in the backward, not kept); the tail is not
    recomputed, as in ``_run_stack``."""
    _, kinds, _, tail = _plan(cfg)
    n = len(views)

    def add(aux, a):
        return [t + u for t, u in zip(aux, a)]

    def group(j, xs, cache_j):
        aux = [torch.zeros((), dtype=torch.float32, device=x.device) for x in xs]
        for i, kind in enumerate(kinds):
            key = f"b{i}_{kind}"
            c = None if cache_j is None else [cj[key] for cj in cache_j]
            xs, a = _block_sharded(cfg, policy, specs,
                                   [v.layers[j][key] for v in views],
                                   f"layers.{j}.{key}.", kind, xs, positions, c,
                                   decode, sp)
            aux = add(aux, a)
        return xs, aux

    aux = [torch.zeros((), dtype=torch.float32, device=x.device) for x in xs]
    for j in range(len(views[0].layers)):
        if caches is None:
            xs, a = maybe_checkpoint(group, cfg, j, xs, None)
        else:
            cache_j = [{key: {name: t[r][j] for name, t in block.items()}
                        for key, block in caches["layers"].items()}
                       for r in range(n)]
            xs, a = group(j, xs, cache_j)
        aux = add(aux, a)
    for i, kind in enumerate(tail):
        c = (None if caches is None else
             [{name: t[r] for name, t in caches["tail"][i].items()}
              for r in range(n)])
        xs, a = _block_sharded(cfg, policy, specs, [v.tail[i] for v in views],
                               f"tail.{i}.", kind, xs, positions, c, decode, sp)
        aux = add(aux, a)
    return xs, caches, aux


def _embed_inputs_sharded(cfg, policy, specs, views, tokens,
                          vision_embeds=None):
    mesh = policy.mesh
    ps = gather_params([v.embed for v in views], specs, mesh, "embed.")
    xs = embed_sharded(ps, tokens, mesh=mesh, axis=MODEL,
                       compute_dtype=COMPUTE_DTYPE)
    if cfg.family == "vlm" and vision_embeds is not None:
        xs = PerRank(torch.cat([ve.to(COMPUTE_DTYPE), x], dim=1)
                     for ve, x in zip(vision_embeds, xs))
    return xs


def _logits_sharded(cfg, policy, specs, views, xs):
    """Final norm and the vocab-parallel head: logits (…, V/|model|)."""
    mesh = policy.mesh
    _, norm = _norm_fns(cfg)
    # each rank's logits over its vocabulary slice; a tied head takes the
    # embedding's shard
    if views[0].lm_head is None:
        embeds = gather_params([v.embed for v in views], specs, mesh, "embed.")
        heads = [None] * len(views)
    else:
        embeds = [v.embed for v in views]
        heads = gather_params([v.lm_head for v in views], specs, mesh,
                              "lm_head.")
    return [unembed(pe, lh, norm(v.final_norm, x))
            for v, pe, lh, x in zip(views, embeds, heads, xs)]


@functools.lru_cache(maxsize=None)
def _lm_specs(cfg: ModelConfig) -> dict:
    """``param_specs`` of ``cfg``'s LM (built on the meta device)."""
    return param_specs(LM(cfg, torch.device("meta")))


def _sharded_parts(cfg, params):
    """(per-rank views, parameter specs) of a ``ShardedModule`` or of its
    views; raises for a config whose attention has no sharded path."""
    attn_mod.check_mesh(cfg)
    if isinstance(params, ShardedModule):
        return rank_views(params), params.specs
    return list(params), _lm_specs(cfg)


def apply_train_sharded(cfg: ModelConfig, policy, params, tokens,
                        vision_embeds=None):
    """``apply_train`` on a mesh: tokens (and vision embeddings) per rank,
    batch rows on the batch axes. Returns (per-rank logits (B/|batch|, S,
    V/|model|) float32, per-rank aux, replicated)."""
    views, specs = _sharded_parts(cfg, params)
    mesh = policy.mesh
    xs = _embed_inputs_sharded(cfg, policy, specs, views, tokens, vision_embeds)
    s = xs[0].shape[1]
    sp = policy.sequence_split(s)
    if sp:
        xs = _seq_chunk(xs, mesh)
    positions = torch.arange(s, device=xs[0].device)[None, :]
    xs, _, aux = _run_stack_sharded(cfg, policy, specs, views, xs, positions,
                                    None, False, sp)
    if sp:
        xs = all_gather(xs, mesh, MODEL, 1)
    logits = _logits_sharded(cfg, policy, specs, views, xs)
    return PerRank(l.float() for l in logits), PerRank(aux)


def _gather_vocab(logits, mesh):
    """Vocab-split logits (…, V/|model|) → whole (…, V) on every rank."""
    return PerRank(l.float() for l in all_gather(logits, mesh, MODEL, -1))


@torch.no_grad()
def prefill_sharded(cfg: ModelConfig, policy, params, tokens, cache_len,
                    vision_embeds=None):
    """``prefill`` on a mesh. Returns (per-rank last logits (B/|batch|, V),
    the cache: ``init_cache``'s tree with ``PerRank`` leaves, each rank's
    K/V (L, B/|batch|, Hkv, cache_len/|model|, Dh) and positions its slice
    of the sequence)."""
    views, specs = _sharded_parts(cfg, params)
    mesh = policy.mesh
    m = axis_size(mesh, MODEL)
    xs = _embed_inputs_sharded(cfg, policy, specs, views, tokens, vision_embeds)
    b, s = xs[0].shape[:2]
    sp = policy.sequence_split(s)
    caches = init_cache_sharded(cfg, policy, b * axis_size(mesh, policy.batch_axes),
                                cache_len, xs[0].dtype, [x.device for x in xs])
    if sp:
        xs = _seq_chunk(xs, mesh)
    positions = torch.arange(s, device=xs[0].device)[None, :]
    xs, caches, _ = _run_stack_sharded(cfg, policy, specs, views, xs,
                                       positions, caches, False, sp)
    if sp:           # the last position lies in the last model rank's chunk
        xs = all_gather(xs, mesh, MODEL, 1)
    logits = _logits_sharded(cfg, policy, specs, views, [x[:, -1:] for x in xs])
    return PerRank(l[:, 0] for l in _gather_vocab(logits, mesh)), caches


@torch.no_grad()
def decode_step_sharded(cfg: ModelConfig, policy, params, token, caches, pos):
    """``decode_step`` on a mesh: token (B/|batch|, 1) and pos per rank;
    the cache (``prefill_sharded``'s layout) updated in place. With
    ``policy.decode_mode`` (``steps.make_decode_step``'s policy) the
    weights stay on their ranks and the residual lies split on d over
    ``data``; without it each block's weights are gathered over ``data``.
    Returns (per-rank logits (B/|batch|, V), caches)."""
    views, specs = _sharded_parts(cfg, params)
    mesh = policy.mesh
    if policy.decode_mode:
        xs = _embed_stationary(policy, views, token)
    else:
        xs = _embed_inputs_sharded(cfg, policy, specs, views, token)
    xs, caches, _ = _run_stack_sharded(cfg, policy, specs, views, xs, pos,
                                       caches, True, False)
    if policy.decode_mode:
        logits = _logits_stationary(cfg, policy, views, xs)
    else:
        logits = _logits_sharded(cfg, policy, specs, views, xs)
    return PerRank(l[:, 0] for l in _gather_vocab(logits, mesh)), caches


def alloc_sharded(structs, policy, devices=None) -> dict:
    """An empty cache of ``(shape, dtype)`` tree ``structs`` laid out as
    ``sharding.cache_partition_specs`` says: each leaf a ``PerRank`` whose
    entry r has ``local_structs``'s shape on ``devices[r]`` (default the
    mesh's); zeros, ``pos`` -1."""
    mesh = policy.mesh
    local = local_structs(structs, cache_partition_specs(structs, policy), mesh)

    def alloc(tree, dev):
        if isinstance(tree, list):
            return [alloc(t, dev) for t in tree]
        if all(isinstance(v, tuple) for v in tree.values()):
            return _alloc(tree, dev)
        return {k: alloc(v, dev) for k, v in tree.items()}

    def per_rank(trees):
        if isinstance(trees[0], list):
            return [per_rank(list(t)) for t in zip(*trees)]
        if isinstance(trees[0], dict):
            return {k: per_rank([t[k] for t in trees]) for k in trees[0]}
        return PerRank(trees)

    return per_rank([alloc(local, d) for d in devices or mesh.devices])


def init_cache_sharded(cfg: ModelConfig, policy, batch: int, cache_len: int,
                       dtype=torch.bfloat16, devices=None) -> dict:
    """``init_cache`` (``batch`` rows in all) laid out over the policy's
    mesh by ``sharding.cache_partition_specs``, every leaf included:
    K/V and positions on the sequence, RWKV-6's ``wkv`` on Dv and its
    shifts on d, Griffin's ``conv`` and ``h`` on d_rnn, ``tail`` too
    (``alloc_sharded``)."""
    return alloc_sharded(cache_shapes(cfg, batch, cache_len, dtype), policy,
                         devices)
