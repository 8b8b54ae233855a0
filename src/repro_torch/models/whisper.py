"""Whisper-medium backbone (arXiv:2212.04356): the encoder-decoder family
(the port's ``repro.models.whisper``).

As in the reference, the conv/audio frontend is a stub: the model takes
precomputed frame embeddings ``frames`` (B, enc_seq, d). The encoder adds
sinusoidal positions and runs full (bidirectional) attention; the decoder
is a causal transformer with learned positions and cross-attention to the
encoder output. Pre-LayerNorm, non-gated GELU MLPs, no rope, and the
unembedding tied to a token table padded to a multiple of 128 rows (the
pad columns' logits are masked to ``-2**30``).

Caches keep the reference's layout: ``{"layers": {"k": (L, B, Hkv, S, Dh),
"v": …, "pos": (L, B, S)}, "cross": {"k": (L, B, S_enc, H, Dh), "v": …}}``.
Prefill fills the self-attention part from the prompt and the cross part
from one encoder pass; ``decode_step`` writes each token into the
self-attention cache in place and reads the cross K/V unchanged.

API (functions of the config and a ``Whisper`` module):
  init_params(gen, cfg, max_dec_positions)       → Whisper
  encode(cfg, params, frames)                    → encoder states
  apply_train(cfg, params, tokens, frames)       → (logits, aux=0)
  prefill(cfg, params, tokens, frames, cache_len) → (logits_last, cache)
  decode_step(cfg, params, token, cache, pos)    → (logits, cache)
  init_dec_cache(cfg, batch, cache_len, enc_seq) → cache

On a mesh (``*_sharded``: an active ``Policy``, a ``ShardedModule`` or its
per-rank views, ``PerRank`` inputs and caches) every layer runs
tensor-parallel as the decoder-only stack's do (``transformer``'s
``_attn_sharded`` / ``_mixer_sharded``). The encoder's residual lies split
on the frames over ``model`` where ``policy.sequence_split`` allows (1500
frames at ``model`` = 4, not at 8), and its states are whole on every rank
for the cross K/V, which each rank projects for its own heads (the
cache's ``cross`` leaves, heads on ``model``); cross-attention is then
head-local. ``pos_embed`` (d on ``data``) is gathered like a weight. The
tied head is vocabulary-parallel over the padded table, and the pad
columns are masked by their global index, so they fall in the last
``model`` rank's slice. A weight-stationary decode step
(``Policy.decode_mode``, ``_decode_stationary``) gathers no weight: the
residual lies split on d over ``data`` and only activations move.
"""
from __future__ import annotations

import functools

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.types import resolve_device
from repro_torch.launch.mesh import axis_index, axis_size
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer
from repro_torch.models.common import (
    Embed,
    LayerNorm,
    embed,
    embed_sharded,
    layernorm,
    sinusoidal_positions,
    truncated_normal_,
    unembed,
)
from repro_torch.models.mlp import MLP, init_mlp, mlp
from repro_torch.sharding import (
    DATA,
    MODEL,
    PerRank,
    ShardedModule,
    all_gather,
    gather_batch,
    gather_params,
    param_specs,
    psum,
)

COMPUTE_DTYPE = torch.bfloat16


class EncBlock(nn.Module):
    """``norm1``, ``attn``, ``norm2``, ``mlp`` (non-gated)."""

    def __init__(self, cfg: ModelConfig, attn: attn_mod.Attention, mlp_: MLP):
        super().__init__()
        device = attn.wq.weight.device
        self.norm1 = LayerNorm(cfg.d_model, device)
        self.norm2 = LayerNorm(cfg.d_model, device)
        self.attn = attn
        self.mlp = mlp_


class DecBlock(nn.Module):
    """``norm1``, ``attn`` (causal self-attention), ``norm_x``, ``xattn``
    (cross-attention, kv heads = ``n_heads``), ``norm2``, ``mlp``."""

    def __init__(self, cfg: ModelConfig, attn: attn_mod.Attention,
                 xattn: attn_mod.Attention, mlp_: MLP):
        super().__init__()
        device = attn.wq.weight.device
        self.norm1 = LayerNorm(cfg.d_model, device)
        self.norm_x = LayerNorm(cfg.d_model, device)
        self.norm2 = LayerNorm(cfg.d_model, device)
        self.attn = attn
        self.xattn = xattn
        self.mlp = mlp_


def _attention(cfg: ModelConfig, n_kv_heads: int, device=None, gen=None):
    if gen is not None:
        return attn_mod.init_attention(gen, cfg.d_model, cfg.n_heads,
                                       n_kv_heads, cfg.head_dim_)
    return attn_mod.Attention(cfg.d_model, cfg.n_heads, n_kv_heads,
                              cfg.head_dim_, device=device)


def _mlp(cfg: ModelConfig, device=None, gen=None):
    if gen is not None:
        return init_mlp(gen, cfg.d_model, cfg.d_ff, gated=False)
    return MLP(cfg.d_model, cfg.d_ff, gated=False, device=device)


def _init_enc_layer(cfg, device=None, gen=None) -> EncBlock:
    """An encoder block, drawn from ``gen`` or left uninitialised."""
    return EncBlock(cfg, _attention(cfg, cfg.n_kv_heads, device, gen),
                    _mlp(cfg, device, gen))


def _init_dec_layer(cfg, device=None, gen=None) -> DecBlock:
    """A decoder block, drawn from ``gen`` or left uninitialised."""
    attn = _attention(cfg, cfg.n_kv_heads, device, gen)
    xattn = _attention(cfg, cfg.n_heads, device, gen)
    return DecBlock(cfg, attn, xattn, _mlp(cfg, device, gen))


def _padded_vocab(cfg: ModelConfig) -> int:
    """Vocab padded to a multiple of 128 (whisper's 51865 → 51968); the
    padded logit columns are masked before softmax and argmax."""
    return ((cfg.vocab + 127) // 128) * 128


def _mask_pad_logits(cfg: ModelConfig, logits, offset: int = 0):
    """The pad columns set to ``-2**30`` in the logits' dtype. ``logits``
    holds the columns from ``offset`` on (on a mesh, a rank's slice of the
    vocabulary), so a column is masked by its global index."""
    n = logits.shape[-1]
    if offset + n <= cfg.vocab:
        return logits
    ok = torch.arange(offset, offset + n, device=logits.device) < cfg.vocab
    return torch.where(ok, logits, torch.tensor(-2.0 ** 30, dtype=logits.dtype,
                                                device=logits.device))


class Whisper(nn.Module):
    """``embed`` (the padded table, tied to the unembedding), ``pos_embed``
    (max_dec_positions, d), ``enc_layers``, ``enc_norm``, ``layers`` (the
    decoder) and ``final_norm``. Built with uninitialised weights
    (``convert.lm_params_from_reference`` copies them in) unless ``gen`` is
    given, as ``init_params`` does."""

    def __init__(self, cfg: ModelConfig, device=None,
                 max_dec_positions: int = 4096, gen=None):
        super().__init__()
        if gen is not None:
            device = gen.device
        self.embed = Embed(_padded_vocab(cfg), cfg.d_model, device)
        self.pos_embed = nn.Parameter(torch.empty(max_dec_positions,
                                                  cfg.d_model, device=device))
        self.enc_layers = nn.ModuleList(_init_enc_layer(cfg, device, gen)
                                        for _ in range(cfg.n_enc_layers))
        self.enc_norm = LayerNorm(cfg.d_model, device)
        self.layers = nn.ModuleList(_init_dec_layer(cfg, device, gen)
                                    for _ in range(cfg.n_layers))
        self.final_norm = LayerNorm(cfg.d_model, device)


@torch.no_grad()
def init_params(gen: torch.Generator, cfg: ModelConfig,
                max_dec_positions: int = 4096) -> Whisper:
    """Random float32 weights on ``gen.device``, drawn from ``gen`` in place:
    ``dense_init`` products, unit LayerNorms, a truncated-normal table and
    ``0.01·normal`` learned positions."""
    params = Whisper(cfg, max_dec_positions=max_dec_positions, gen=gen)
    truncated_normal_(params.embed.tokens, gen, 1.0)
    params.pos_embed.normal_(generator=gen).mul_(0.01)
    return params


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def _enc_body(p: EncBlock, cfg: ModelConfig, x, positions):
    h = layernorm(p.norm1, x)
    o, _ = attn_mod.attend(p.attn, h, positions, kind="full",
                           dense_max_seq=cfg.dense_attn_max,
                           **attn_mod.gqa_kw(cfg))
    x = x + o
    return x + mlp(p.mlp, layernorm(p.norm2, x), act="gelu")


def encode(cfg: ModelConfig, params: Whisper, frames):
    """frames: (B, enc_seq, d) stub embeddings → encoder states (B, enc_seq,
    d) in the compute dtype."""
    s = frames.shape[1]
    x = frames.to(COMPUTE_DTYPE) + sinusoidal_positions(
        s, cfg.d_model, frames.device).to(COMPUTE_DTYPE)[None]
    positions = torch.arange(s, device=frames.device)[None, :]
    for p in params.enc_layers:
        x = transformer.maybe_checkpoint(_enc_body, cfg, p, cfg, x, positions)
    return layernorm(params.enc_norm, x)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def _dec_block(p: DecBlock, cfg: ModelConfig, x, positions, enc_kv, cache,
               decode):
    """One decoder block; returns (x, cache). ``cache`` is None in training;
    in prefill the returned cache is a new one built from this pass's K/V;
    in decode the token is written into ``cache`` in place."""
    h = layernorm(p.norm1, x)
    if decode:
        o, cache = attn_mod.GQA.decode(p.attn, cfg, h, cache, positions)
    else:
        o, cache = attn_mod.GQA.seq(p.attn, cfg, h, positions, cache)
    x = x + o
    h = layernorm(p.norm_x, x)
    x = x + attn_mod.cross_attend(
        p.xattn, h, enc_kv, n_heads=cfg.n_heads, n_kv_heads=cfg.n_heads,
        head_dim=cfg.head_dim_)
    x = x + mlp(p.mlp, layernorm(p.norm2, x), act="gelu")
    return x, cache


def _train_dec_body(p, cfg, x, positions, k, v):
    return _dec_block(p, cfg, x, positions, (k, v), None, False)[0]


def _cross_kv(cfg: ModelConfig, params: Whisper, enc_out):
    """Every decoder layer's cross-attention K and V from the encoder
    output, stacked: two (L, B, S_enc, H, Dh) tensors."""
    kvs = [attn_mod.encoder_kv(p.xattn, enc_out, n_kv_heads=cfg.n_heads,
                               head_dim=cfg.head_dim_) for p in params.layers]
    return (torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs]))


def _decoder(cfg: ModelConfig, params: Whisper, x, positions, cross_kv,
             caches, decode):
    """Walk the decoder layers; with ``caches`` each layer reads and writes
    its slice of ``caches["layers"]`` in place. Returns (x, caches)."""
    for i, p in enumerate(params.layers):
        k, v = cross_kv[0][i], cross_kv[1][i]
        if caches is None:
            x = transformer.maybe_checkpoint(_train_dec_body, cfg, p, cfg, x,
                                             positions, k, v)
            continue
        cache = {name: t[i] for name, t in caches["layers"].items()}
        x, new = _dec_block(p, cfg, x, positions, (k, v), cache, decode)
        transformer._store(cache, new)
    return x, caches


def _embed_dec(cfg: ModelConfig, params: Whisper, tokens, pos0: int = 0):
    """Token rows plus the learned positions ``pos0 … pos0 + S - 1``."""
    x = embed(params.embed, tokens, COMPUTE_DTYPE)
    s = tokens.shape[1]
    return x + params.pos_embed[pos0:pos0 + s].to(COMPUTE_DTYPE)


def _logits(cfg: ModelConfig, params: Whisper, x):
    """Tied unembedding over the padded table, pad columns masked, float32."""
    x = layernorm(params.final_norm, x)
    return _mask_pad_logits(cfg, unembed(params.embed, None, x)).float()


def apply_train(cfg: ModelConfig, params: Whisper, tokens, frames):
    """(tokens (B, S), frames (B, enc_seq, d)) → (logits (B, S, V_pad)
    float32, aux = 0). A forward pass with autograd on."""
    enc_out = encode(cfg, params, frames)
    cross_kv = _cross_kv(cfg, params, enc_out)
    x = _embed_dec(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
    x, _ = _decoder(cfg, params, x, positions, cross_kv, None, False)
    return _logits(cfg, params, x), torch.zeros((), dtype=torch.float32,
                                                device=x.device)


# ---------------------------------------------------------------------------
# Caches, prefill and decode
# ---------------------------------------------------------------------------


def cache_shapes(cfg: ModelConfig, batch: int, cache_len: int, enc_seq: int,
                 dtype=torch.bfloat16) -> dict:
    """The cache's ``(shape, dtype)`` per tensor, allocating nothing: the
    self-attention K/V in ``dtype`` (bf16 in the reference's
    ``init_dec_cache``) and the cross K/V in ``COMPUTE_DTYPE``."""
    n = cfg.n_layers
    cross = (n, batch, enc_seq, cfg.n_heads, cfg.head_dim_)
    return {"layers": {name: ((n,) + shape, dt) for name, (shape, dt) in
                       attn_mod.GQA.cache_shapes(cfg, batch, cache_len,
                                                 dtype).items()},
            "cross": {"k": (cross, COMPUTE_DTYPE), "v": (cross, COMPUTE_DTYPE)}}


def init_dec_cache(cfg: ModelConfig, batch: int, cache_len: int, enc_seq: int,
                   dtype=torch.bfloat16, device="cuda") -> dict:
    """An empty cache on ``device``: zeros, ``pos`` -1 (empty slots)."""
    dev = resolve_device(device)
    return {part: transformer._alloc(block, dev) for part, block in
            cache_shapes(cfg, batch, cache_len, enc_seq, dtype).items()}


@torch.no_grad()
def prefill(cfg: ModelConfig, params: Whisper, tokens, frames, cache_len):
    """One encoder pass and the decoder over the prompt. The cache holds
    the prompt's self-attention K/V and every layer's cross K/V, both in
    the compute dtype (as the reference's prefill returns them).

    Returns (last-position logits (B, V_pad) float32, caches)."""
    enc_out = encode(cfg, params, frames)
    k, v = _cross_kv(cfg, params, enc_out)
    del enc_out
    x = _embed_dec(cfg, params, tokens)
    b, s = tokens.shape
    caches = {"layers": transformer._alloc(cache_shapes(
        cfg, b, cache_len, frames.shape[1], x.dtype)["layers"], x.device)}
    positions = torch.arange(s, device=x.device)[None, :]
    x, caches = _decoder(cfg, params, x, positions, (k, v), caches, False)
    caches["cross"] = {"k": k.to(COMPUTE_DTYPE), "v": v.to(COMPUTE_DTYPE)}
    return _logits(cfg, params, x[:, -1:])[:, 0], caches


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Whisper, token, caches, pos):
    """token: (B, 1) int; pos: (B,) absolute positions. Updates the
    self-attention part of ``caches`` in place and reads the cross part.
    Returns (logits (B, V_pad) float32, caches)."""
    x = embed(params.embed, token, COMPUTE_DTYPE)
    x = x + params.pos_embed[pos.long()][:, None].to(COMPUTE_DTYPE)
    cross = (caches["cross"]["k"], caches["cross"]["v"])
    x, _ = _decoder(cfg, params, x, pos[:, None], cross,
                    {"layers": caches["layers"]}, True)
    return _logits(cfg, params, x)[:, 0], caches


# ---------------------------------------------------------------------------
# On a mesh
# ---------------------------------------------------------------------------

# ``attend``'s default block, which ``encode`` keeps (blockwise attention
# only runs above ``dense_attn_max`` frames)
ENC_KV_BLOCK = 512


@functools.lru_cache(maxsize=None)
def _whisper_specs(cfg: ModelConfig) -> dict:
    """``param_specs`` of ``cfg``'s ``Whisper`` (built on the meta device;
    the specs do not depend on ``max_dec_positions``)."""
    return param_specs(Whisper(cfg, torch.device("meta")))


def _parts(cfg, params):
    """(per-rank views, parameter specs) of a ``ShardedModule`` or of its
    views."""
    if isinstance(params, ShardedModule):
        return transformer.rank_views(params), params.specs
    return list(params), _whisper_specs(cfg)


def _gather_layer(cfg, specs, mesh, views, stack: str, i: int):
    """Layer ``i`` of ``stack`` on every rank, gathered over ``data``."""
    return gather_params([getattr(v, stack)[i] for v in views], specs, mesh,
                         f"{stack}.{i}.", extra=attn_mod.kv_extra_gather(
                             cfg.n_kv_heads, axis_size(mesh, MODEL), "attn."))


def _enc_layer_sharded(cfg, policy, specs, views, i, xs, positions, sp):
    ps = _gather_layer(cfg, specs, policy.mesh, views, "enc_layers", i)
    xs, _ = transformer._attn_sharded(ps, cfg, policy, xs, positions, None,
                                      decode=False, sp=sp, kind="full",
                                      kv_block=ENC_KV_BLOCK)
    return transformer._mixer_sharded(ps, cfg, policy, xs, sp=sp)[0]


def _encode(cfg, policy, specs, views, frames):
    mesh = policy.mesh
    s = frames[0].shape[1]
    xs = [f.to(COMPUTE_DTYPE) + sinusoidal_positions(
        s, cfg.d_model, f.device).to(COMPUTE_DTYPE)[None] for f in frames]
    sp = policy.sequence_split(s)
    if sp:
        xs = transformer._seq_chunk(xs, mesh)
    positions = torch.arange(s, device=xs[0].device)[None, :]
    for i in range(len(views[0].enc_layers)):
        xs = transformer.maybe_checkpoint(_enc_layer_sharded, cfg, cfg, policy,
                                          specs, views, i, xs, positions, sp)
    xs = [layernorm(v.enc_norm, x) for v, x in zip(views, xs)]
    return all_gather(xs, mesh, MODEL, 1) if sp else xs


def encode_sharded(cfg: ModelConfig, policy, params, frames):
    """``encode`` on a mesh: frames per rank (B/|batch|, enc_seq, d), the
    residual split on the frames over ``model`` where
    ``policy.sequence_split(enc_seq)`` holds (an indivisible count keeps it
    whole, the same values). Returns per-rank encoder states, every frame
    on every rank."""
    views, specs = _parts(cfg, params)
    return _encode(cfg, policy, specs, views, frames)


def _dec_layer_sharded(cfg, policy, specs, views, i, xs, positions, enc,
                       cross, cache, decode, sp):
    """Decoder layer ``i`` on every rank. ``enc``: per-rank encoder states,
    from which each rank projects its heads' cross K/V (training and
    prefill), or None with ``cross`` given (decode, from the cache);
    ``cache``: per-rank self-attention cache dicts or None. Returns (xs,
    the per-rank cross K/V)."""
    mesh = policy.mesh
    ps = _gather_layer(cfg, specs, mesh, views, "layers", i)
    if cross is None:
        hm = cfg.n_heads // axis_size(mesh, MODEL)
        cross = [attn_mod.encoder_kv(p.xattn, e, n_kv_heads=hm,
                                     head_dim=cfg.head_dim_)
                 for p, e in zip(ps, enc)]
    xs, _ = transformer._attn_sharded(ps, cfg, policy, xs, positions, cache,
                                      decode=decode, sp=sp)
    hs = [layernorm(p.norm_x, x) for p, x in zip(ps, xs)]
    if sp:
        hs = all_gather(hs, mesh, MODEL, 1)
    ys = attn_mod.cross_attend_sharded([p.xattn for p in ps], hs, cross,
                                       head_dim=cfg.head_dim_)
    xs = [x + y.to(x.dtype)
          for x, y in zip(xs, transformer._reduce_model(ys, mesh, sp))]
    xs, _ = transformer._mixer_sharded(ps, cfg, policy, xs, sp=sp)
    return xs, cross


def _train_dec_layer_sharded(cfg, policy, specs, views, i, xs, positions,
                             enc, sp):
    return _dec_layer_sharded(cfg, policy, specs, views, i, xs, positions,
                              enc, None, None, False, sp)[0]


def _decoder_sharded(cfg, policy, specs, views, xs, positions, enc, caches,
                     decode, sp):
    """Walk the decoder layers on every rank. Training (no ``caches``): each
    layer through ``maybe_checkpoint``. Prefill (``enc`` and ``caches``):
    each layer writes its self-attention slice and its cross K/V into
    ``caches``. Decode (``caches``, no ``enc``): the cross K/V come from
    the cache. Returns xs."""
    n = len(views)
    for i in range(len(views[0].layers)):
        if caches is None:
            xs = transformer.maybe_checkpoint(
                _train_dec_layer_sharded, cfg, cfg, policy, specs, views, i,
                xs, positions, enc, sp)
            continue
        cache = [{name: t[r][i] for name, t in caches["layers"].items()}
                 for r in range(n)]
        cross = None if enc is not None else [
            (caches["cross"]["k"][r][i], caches["cross"]["v"][r][i])
            for r in range(n)]
        xs, cross = _dec_layer_sharded(cfg, policy, specs, views, i, xs,
                                       positions, enc, cross, cache, decode, sp)
        if enc is not None:
            for r, (k, v) in enumerate(cross):
                caches["cross"]["k"][r][i].copy_(k)
                caches["cross"]["v"][r][i].copy_(v)
    return xs


def _embed_dec_sharded(cfg, policy, specs, views, tokens, pos=None):
    """Vocab-parallel token rows plus the learned positions (0 … S-1, or
    ``pos`` per rank in decode); ``pos_embed`` gathered over ``data``."""
    mesh = policy.mesh
    ps = gather_params([v.embed for v in views], specs, mesh, "embed.")
    xs = embed_sharded(ps, tokens, mesh=mesh, axis=MODEL,
                       compute_dtype=COMPUTE_DTYPE)
    tables = all_gather(PerRank(v.pos_embed for v in views), mesh, DATA,
                        specs["pos_embed"].index(DATA))
    rows = ([t[:x.shape[1]] for t, x in zip(tables, xs)] if pos is None else
            [t[p.long()][:, None] for t, p in zip(tables, pos)])
    return [x + r.to(COMPUTE_DTYPE) for x, r in zip(xs, rows)]


def _logits_sharded(cfg, policy, specs, views, xs):
    """Final norm and the tied head over each rank's slice of the padded
    vocabulary, the pad columns masked by global index; float32."""
    mesh = policy.mesh
    ps = gather_params([v.embed for v in views], specs, mesh, "embed.")
    out = []
    for r, (v, pe, x) in enumerate(zip(views, ps, xs)):
        lg = unembed(pe, None, layernorm(v.final_norm, x))
        out.append(_mask_pad_logits(
            cfg, lg, axis_index(mesh, r, MODEL) * lg.shape[-1]).float())
    return out


def apply_train_sharded(cfg: ModelConfig, policy, params, tokens, frames):
    """``apply_train`` on a mesh: tokens and frames per rank, batch rows on
    the batch axes. Returns (per-rank logits (B/|batch|, S, V_pad/|model|)
    float32, per-rank aux = 0)."""
    views, specs = _parts(cfg, params)
    mesh = policy.mesh
    enc = _encode(cfg, policy, specs, views, frames)
    xs = _embed_dec_sharded(cfg, policy, specs, views, tokens)
    s = xs[0].shape[1]
    sp = policy.sequence_split(s)
    if sp:
        xs = transformer._seq_chunk(xs, mesh)
    positions = torch.arange(s, device=xs[0].device)[None, :]
    xs = _decoder_sharded(cfg, policy, specs, views, xs, positions, enc, None,
                          False, sp)
    if sp:
        xs = all_gather(xs, mesh, MODEL, 1)
    return (PerRank(_logits_sharded(cfg, policy, specs, views, xs)),
            PerRank(torch.zeros((), dtype=torch.float32, device=x.device)
                    for x in xs))


def init_dec_cache_sharded(cfg: ModelConfig, policy, batch: int,
                           cache_len: int, enc_seq: int, dtype=torch.bfloat16,
                           devices=None) -> dict:
    """``init_dec_cache`` (``batch`` rows in all) laid out over the policy's
    mesh by ``sharding.cache_partition_specs``: the self-attention K/V and
    positions on the sequence, the cross K/V on the heads."""
    return transformer.alloc_sharded(
        cache_shapes(cfg, batch, cache_len, enc_seq, dtype), policy, devices)


@torch.no_grad()
def prefill_sharded(cfg: ModelConfig, policy, params, tokens, frames,
                    cache_len):
    """``prefill`` on a mesh. Returns (per-rank last logits (B/|batch|,
    V_pad), the cache laid out as ``init_dec_cache_sharded`` says)."""
    views, specs = _parts(cfg, params)
    mesh = policy.mesh
    enc = _encode(cfg, policy, specs, views, frames)
    xs = _embed_dec_sharded(cfg, policy, specs, views, tokens)
    b, s = xs[0].shape[:2]
    sp = policy.sequence_split(s)
    caches = init_dec_cache_sharded(
        cfg, policy, b * axis_size(mesh, policy.batch_axes), cache_len,
        frames[0].shape[1], xs[0].dtype, [x.device for x in xs])
    if sp:
        xs = transformer._seq_chunk(xs, mesh)
    positions = torch.arange(s, device=xs[0].device)[None, :]
    xs = _decoder_sharded(cfg, policy, specs, views, xs, positions, enc,
                          caches, False, sp)
    del enc
    if sp:           # the last position lies in the last model rank's chunk
        xs = all_gather(xs, mesh, MODEL, 1)
    logits = _logits_sharded(cfg, policy, specs, views, [x[:, -1:] for x in xs])
    return (PerRank(lg[:, 0] for lg in transformer._gather_vocab(logits, mesh)),
            caches)


def _decode_stationary(cfg, policy, views, token, caches, pos):
    """A weight-stationary decode step (``Policy.decode_mode``): the
    residual (rows, 1, d/|data|) on every rank; the token rows and the
    learned positions looked up in each rank's ``data`` slice of d; per
    layer ``transformer``'s stationary self-attention, the cross-attention
    against the cached K/V (``cross_attend_stationary``: ``xattn``'s
    ``wk`` / ``wv`` are never read) and the MLP, no weight gathered; the
    tied head over the padded vocabulary. Returns per-rank logits
    (B/|batch|, 1, V_pad/|model|) in the compute dtype."""
    mesh = policy.mesh
    xs = transformer._embed_stationary(policy, views, token)
    xs = [x + v.pos_embed[p.long()][:, None].to(COMPUTE_DTYPE)
          for v, x, p in zip(views, xs, gather_batch(pos, policy))]
    for i in range(len(views[0].layers)):
        blocks = [v.layers[i] for v in views]
        cache = [{name: t[r][i] for name, t in caches["layers"].items()}
                 for r in range(len(views))]
        xs = transformer._attn_stationary(blocks, cfg, policy, xs, pos, cache)
        hs = transformer._norm_stationary(cfg, [b.norm_x for b in blocks], xs,
                                          mesh)
        ys = attn_mod.cross_attend_stationary(
            [b.xattn for b in blocks], hs,
            [(caches["cross"]["k"][r][i], caches["cross"]["v"][r][i])
             for r in range(len(views))], policy=policy, head_dim=cfg.head_dim_)
        xs = [x + y.to(x.dtype) for x, y in zip(xs, psum(ys, mesh, MODEL))]
        xs = transformer._mlp_stationary(blocks, cfg, policy, xs)
    return transformer._logits_stationary(
        cfg, policy, views, xs, functools.partial(_mask_pad_logits, cfg))


@torch.no_grad()
def decode_step_sharded(cfg: ModelConfig, policy, params, token, caches, pos):
    """``decode_step`` on a mesh: token (B/|batch|, 1) and pos per rank; the
    self-attention cache updated in place, the cross K/V read; weight
    stationary with ``policy.decode_mode`` (``_decode_stationary``), else
    each layer gathered over ``data``. Returns (per-rank logits
    (B/|batch|, V_pad), caches)."""
    views, specs = _parts(cfg, params)
    if policy.decode_mode:
        logits = _decode_stationary(cfg, policy, views, token, caches, pos)
        return (PerRank(lg[:, 0] for lg in transformer._gather_vocab(
            logits, policy.mesh)), caches)
    xs = _embed_dec_sharded(cfg, policy, specs, views, token, pos)
    xs = _decoder_sharded(cfg, policy, specs, views, xs, pos, None, caches,
                          True, False)
    logits = _logits_sharded(cfg, policy, specs, views, xs)
    return (PerRank(lg[:, 0] for lg in transformer._gather_vocab(
        logits, policy.mesh)), caches)
