"""Attention: GQA with rope / qk-norm / bias, causal and sliding-window
masks, dense and blockwise (flash-style) paths, and KV caches. The port's
``repro.models.attention`` on one device.

Cache layout (per layer): ``{"k": (B, Hkv, S, Dh), "v": same, "pos": (B, S)}``.
``pos`` is the absolute position stored in each slot (-1 = empty). Sliding
windows use rolling-buffer caches of size ``min(window, seq)``. K is stored
post-rope.

The arithmetic mirrors the reference's: einsum products in the compute
dtype, scores masked with ``NEG_INF`` and softmaxed in float32, the weights
cast back to the compute dtype. ``decode_attend`` writes the new token into
the cache it is given, in place, and returns that same cache.

Multi-head latent attention (``MLAttention``, DeepSeek-V2's MLA, for an
``MLAConfig``): queries from ``wq``; one joint low-rank projection
``wkv_a`` to the latent ``c`` (RMS-normed, ``kv_norm``) and a rope key
``k_R`` shared by every head; ``wkv_b`` expands ``c`` into each head's
``k_C`` and ``v``. Keys are ``[k_C; k_R]``, so the query/key head dim
(``qk_nope + qk_rope``) differs from the value head dim, which the dense
and blockwise cores take; on the card, in bf16, the core is the
hand-written causal kernel of ``kernels/mla_attention.py``, forward and
backward, which keeps the S × S scores out of device memory. Its decode
cache is the latent only:
``{"c": (B, S, kv_lora_rank), "kr": (B, S, qk_rope), "pos": (B, S)}``;
decode absorbs ``wkv_b`` into the query and the output, so no per-head K
or V is ever stored. MLA runs on one device only.

On a mesh (``*_sharded``, per-rank lists): head-parallel ``attend`` for
prefill and training (``n_heads / model`` query heads per rank, the K/V
heads they read; ``wo`` row-parallel, its partial sums reduced by the
caller), the reference's flash-decode over a cache split on ``S`` over
``model`` (``decode_attend_sharded``), and head-parallel cross-attention
over encoder K/V with heads on ``model`` (``cross_attend_sharded``). In a
weight-stationary decode step (``Policy.decode_mode``) the projections
contract the residual's ``data`` slice with each rank's own weight shard
and only activations move (``decode_attend_stationary``,
``cross_attend_stationary``).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import mla_attention
from repro_torch.launch.mesh import axis_index, axis_size
from repro_torch.models.common import (
    RMSNorm,
    apply_rope,
    empty_linear,
    init_linear_,
    linear_f32,
    rmsnorm,
    rotate,
    yarn_freqs,
    yarn_mscale,
)
from repro_torch.sharding import (
    MODEL,
    PerRank,
    all_gather,
    gather_batch,
    module_view,
    pmax,
    psum,
    psum_to_batch,
)

from repro_torch.spans import span

NEG_INF = -2.0 ** 30  # large-but-finite: keeps masked softmax NaN-free


class Attention(nn.Module):
    """``wq``, ``wk``, ``wv`` (with biases when ``qkv_bias``), ``wo``, and
    per-head ``q_norm`` / ``k_norm`` when ``qk_norm``."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int,
                 head_dim: int, *, qkv_bias: bool = False,
                 qk_norm: bool = False, device=None):
        super().__init__()
        self.wq = empty_linear(d_model, n_heads * head_dim, bias=qkv_bias,
                               device=device)
        self.wk = empty_linear(d_model, n_kv_heads * head_dim, bias=qkv_bias,
                               device=device)
        self.wv = empty_linear(d_model, n_kv_heads * head_dim, bias=qkv_bias,
                               device=device)
        self.wo = empty_linear(n_heads * head_dim, d_model, device=device)
        self.q_norm = RMSNorm(head_dim, device) if qk_norm else None
        self.k_norm = RMSNorm(head_dim, device) if qk_norm else None


def init_attention(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv_heads: int, head_dim: int, *, qkv_bias: bool = False,
                   qk_norm: bool = False) -> Attention:
    """An ``Attention`` on the generator's device: ``dense_init`` weights,
    zero biases, unit norm scales."""
    p = Attention(d_model, n_heads, n_kv_heads, head_dim, qkv_bias=qkv_bias,
                  qk_norm=qk_norm, device=gen.device)
    for lin in (p.wq, p.wk, p.wv, p.wo):
        init_linear_(gen, lin)
    return p


def _proj(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    bias = None if lin.bias is None else lin.bias.to(x.dtype)
    return F.linear(x, lin.weight.to(x.dtype), bias)


def _project_qkv(p: Attention, x, n_heads, n_kv_heads, head_dim, positions,
                 theta, use_rope=True):
    b, s, _ = x.shape
    q = _proj(p.wq, x).reshape(b, s, n_heads, head_dim)
    k = _proj(p.wk, x).reshape(b, s, n_kv_heads, head_dim)
    v = _proj(p.wv, x).reshape(b, s, n_kv_heads, head_dim)
    return _finish_qk(p, q, k, positions, theta, use_rope) + (v,)


def _finish_qk(p: Attention, q, k, positions, theta, use_rope):
    """The projected q and k (B, S, heads, Dh) through qk-norm and rope."""
    if p.q_norm is not None:  # qwen3-style per-head rms norm
        q = rmsnorm(p.q_norm, q)
        k = rmsnorm(p.k_norm, k)
    if use_rope:
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    return q, k


def _mask(q_pos, k_pos, kind, window):
    """q_pos: (…, Sq), k_pos: (…, Sk) → bool (…, Sq, Sk) allowed."""
    dq = q_pos[..., :, None]
    dk = k_pos[..., None, :]
    ok = dk >= 0
    if kind == "causal":
        ok = ok & (dk <= dq)
        if window is not None:
            ok = ok & (dk > dq - window)
    elif kind != "full":
        raise ValueError(kind)
    return ok


def _repeat_kv(k, g):
    """(B, S, Hkv, Dh) → (B, S, H, Dh): query head h reads kv head h // g."""
    if g == 1:
        return k
    return k.repeat_interleave(g, dim=2)


def _sdpa(q, k, v, mask, scale):
    """Dense attention. q: (B,Sq,H,Dh), k: (B,Sk,Hkv,Dh), v: (B,Sk,Hkv,Dv)
    (Dv may differ from Dh), mask (B,Sq,Sk) → (B,Sq,H,Dv)."""
    g = q.shape[2] // k.shape[2]
    k = _repeat_kv(k, g)
    v = _repeat_kv(v, g)
    scores = torch.einsum("bqhd,bshd->bhqs", q, k) * scale   # (B,H,Sq,Sk)
    scores = torch.where(mask[:, None], scores.float(), NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshd->bqhd", w, v)


def _blockwise_sdpa(q, k, v, q_pos, k_pos, kind, window, scale, kv_block=512):
    """Flash-style attention: a loop over KV blocks with running (max,
    denom, acc) in float32, so live memory is O(Sq · kv_block), not O(Sq²).
    The value head dim may differ from the query/key one."""
    b, sq, h, dh = q.shape
    g = h // k.shape[2]
    k = _repeat_kv(k, g)
    v = _repeat_kv(v, g)
    pad = (-k.shape[1]) % kv_block
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=-1)

    acc = torch.zeros((b, sq, h, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    for start in range(0, k.shape[1], kv_block):
        kc = k[:, start:start + kv_block]
        vc = v[:, start:start + kv_block]
        pc = k_pos[:, start:start + kv_block]
        s = torch.einsum("bqhd,bshd->bhqs", q, kc).float() * scale
        ok = _mask(q_pos, pc, kind, window)               # (B, Sq, blk)
        s = torch.where(ok[:, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha.transpose(1, 2)[..., None] + torch.einsum(
            "bhqs,bshd->bqhd", p.to(q.dtype), vc).float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def _broadcast_positions(positions, shape):
    """(S,) or (B, S) positions → (B, S)."""
    return (positions if positions.ndim == 2 else positions[None]).expand(shape)


def _attend_heads(p: Attention, x, positions, *, n_heads, n_kv_heads,
                  head_dim, rope_theta, kind, window, use_rope, dense_max_seq,
                  kv_block):
    """``attend`` up to ``wo``: (heads' outputs (B, S, H·Dh), (k, v))."""
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim, positions,
                           rope_theta, use_rope)
    scale = head_dim ** -0.5
    pos2 = _broadcast_positions(positions, x.shape[:2])
    if x.shape[1] <= dense_max_seq:
        out = _sdpa(q, k, v, _mask(pos2, pos2, kind, window), scale)
    else:
        out = _blockwise_sdpa(q, k, v, pos2, pos2, kind, window, scale,
                              kv_block)
    return out.reshape(*x.shape[:2], n_heads * head_dim), (k, v)


def attend(p: Attention, x, positions, *, n_heads, n_kv_heads, head_dim,
           rope_theta, kind="causal", window=None, use_rope=True,
           dense_max_seq=8192, kv_block=512):
    """Full-sequence attention (training / prefill). x: (B, S, D) →
    (y (B, S, D), (k, v) each (B, S, Hkv, Dh))."""
    out, kv = _attend_heads(
        p, x, positions, n_heads=n_heads, n_kv_heads=n_kv_heads,
        head_dim=head_dim, rope_theta=rope_theta, kind=kind, window=window,
        use_rope=use_rope, dense_max_seq=dense_max_seq, kv_block=kv_block)
    return F.linear(out, p.wo.weight.to(x.dtype)), kv


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------


def init_cache(batch, cache_len, n_kv_heads, head_dim, dtype=torch.bfloat16,
               device=None):
    """An empty decode cache, layout (B, Hkv, S, Dh): the decode products
    read it without a transpose."""
    return {
        "k": torch.zeros((batch, n_kv_heads, cache_len, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, n_kv_heads, cache_len, head_dim), dtype=dtype,
                         device=device),
        "pos": torch.full((batch, cache_len), -1, dtype=torch.int32,
                          device=device),
    }


def cache_from_prefill(k, v, positions, cache_len):
    """Keep the trailing ``cache_len`` positions (rolling buffer for SWA).
    k, v: (B, S, Hkv, Dh) from the prefill pass → (B, Hkv, S', Dh) cache."""
    s = k.shape[1]
    kt = k.transpose(1, 2)                                # (B, Hkv, S, Dh)
    vt = v.transpose(1, 2)
    pos2 = _broadcast_positions(positions, k.shape[:2]).to(torch.int32)
    if s <= cache_len:
        pad = cache_len - s
        return {"k": F.pad(kt, (0, 0, 0, pad)), "v": F.pad(vt, (0, 0, 0, pad)),
                "pos": F.pad(pos2, (0, pad), value=-1)}
    # rolling placement: absolute position t lives in slot t % cache_len
    keep = torch.arange(s - cache_len, s, device=k.device)
    slots = keep % cache_len
    out = init_cache(k.shape[0], cache_len, k.shape[2], k.shape[3], k.dtype,
                     k.device)
    out["k"][:, :, slots] = kt[:, :, keep]
    out["v"][:, :, slots] = vt[:, :, keep]
    out["pos"][:, slots] = pos2[:, keep]
    return out


def _dot_f32(a, b):
    """Batched ``a @ b`` accumulated and returned in float32, like the
    reference's ``preferred_element_type=float32``. On the card two bf16
    operands go to ``bmm(..., out_dtype=float32)``, so the cache is never
    upcast (a float32 copy of a layer's cache is 1 GB at B=4, 32k); the
    CPU has no such kernel, so there both operands are upcast, which is the
    same function."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        lead = a.shape[:-2]
        out = torch.bmm(a.reshape(-1, *a.shape[-2:]),
                        b.reshape(-1, *b.shape[-2:]), out_dtype=torch.float32)
        return out.reshape(*lead, *out.shape[-2:])
    return torch.matmul(a.float(), b.float())


def _decode_attend_local(q, cache_k, cache_v, cache_pos, pos, scale):
    """Single-token attention against a cache; returns the un-normalised
    flash-decode partials (acc, m, l).

    q: (B, H, Dh); cache: (B, Hkv, S, Dh); pos: (B,) current position.
    """
    b, h, dh = q.shape
    hkv = cache_k.shape[1]
    qg = q.reshape(b, hkv, h // hkv, dh)
    s = _dot_f32(qg, cache_k.transpose(-1, -2)) * scale  # (B, Hkv, G, S)
    ok = (cache_pos >= 0) & (cache_pos <= pos[:, None])   # (B, S)
    s = torch.where(ok[:, None, None], s, NEG_INF)
    m = s.amax(-1)                                        # (B, Hkv, G)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    acc = _dot_f32(p.to(cache_v.dtype), cache_v)          # (B, Hkv, G, Dh)
    return acc, m, l


def decode_attend(p: Attention, x, cache, pos, *, n_heads, n_kv_heads,
                  head_dim, rope_theta, window, use_rope=True):
    """One-token decode: x (B, 1, D); pos (B,) or (B, 1) absolute positions.

    Writes the token's K/V and position into slot ``pos % cache_len`` of
    ``cache`` in place, attends over the slots the position (and window)
    allows, and returns ``(y (B, 1, D), cache)``."""
    b = x.shape[0]
    positions = pos[:, None] if pos.ndim == 1 else pos
    q, k_new, v_new = _project_qkv(p, x, n_heads, n_kv_heads, head_dim,
                                   positions, rope_theta, use_rope)
    q = q[:, 0]                                           # (B, H, Dh)
    cache_len = cache["k"].shape[2]                       # (B, Hkv, S, Dh)
    pos_b = positions[:, 0]
    slot = (pos_b % cache_len).long()
    bidx = torch.arange(b, device=x.device)
    # (B, Hkv, Dh) into (B, Hkv, S, Dh) at [b, :, slot[b]]
    cache["k"][bidx, :, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][bidx, :, slot] = v_new[:, 0].to(cache["v"].dtype)
    cache["pos"][bidx, slot] = pos_b.to(torch.int32)
    cpos = cache["pos"]
    if window is not None:
        cpos = torch.where(cpos > (pos_b[:, None] - window), cpos, -1)
    acc, m, l = _decode_attend_local(q, cache["k"], cache["v"], cpos, pos_b,
                                     head_dim ** -0.5)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.reshape(b, 1, n_heads * head_dim).to(x.dtype)
    return F.linear(out, p.wo.weight.to(x.dtype)), cache


# ---------------------------------------------------------------------------
# Multi-head latent attention (MLA) and its latent cache
# ---------------------------------------------------------------------------


class MLAttention(nn.Module):
    """``wq`` (d → H·(qk_nope + qk_rope)), ``wkv_a`` (d → kv_lora_rank +
    qk_rope), ``kv_norm`` (the latent's RMS scale), ``wkv_b`` (kv_lora_rank
    → H·(qk_nope + v)), ``wo`` (H·v → d); no biases."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        self.wq = empty_linear(d, h * cfg.qk_head_dim, device=device)
        self.wkv_a = empty_linear(d, cfg.kv_lora_rank + cfg.qk_rope_head_dim,
                                  device=device)
        self.kv_norm = RMSNorm(cfg.kv_lora_rank, device)
        self.wkv_b = empty_linear(
            cfg.kv_lora_rank, h * (cfg.qk_nope_head_dim + cfg.v_head_dim),
            device=device)
        self.wo = empty_linear(h * cfg.v_head_dim, d, device=device)


def init_mla(gen: torch.Generator, cfg) -> MLAttention:
    """An ``MLAttention`` on the generator's device: ``dense_init`` weights,
    a unit latent norm."""
    p = MLAttention(cfg, device=gen.device)
    for lin in (p.wq, p.wkv_a, p.wkv_b, p.wo):
        init_linear_(gen, lin)
    return p


def mla_scale(cfg) -> float:
    """The softmax scale: ``qk_head_dim^-0.5 · m(mscale_all_dim)²``."""
    m = yarn_mscale(cfg.rope_factor, cfg.mscale_all_dim)
    return cfg.qk_head_dim ** -0.5 * m * m


@functools.cache
def _yarn_table(dim, theta, factor, beta_fast, beta_slow, original_max, device):
    """``yarn_freqs`` once a process per config and device: a constant that
    each layer's forward and recompute would otherwise rebuild with a dozen
    small launches."""
    with torch.inference_mode(False), torch.no_grad():
        return yarn_freqs(dim, theta, factor, beta_fast, beta_slow, original_max,
                          device)


def mla_rope(cfg, t, positions):
    """YaRN rope of ``t`` (B, S, heads, qk_rope): the config's blended
    frequencies, cos/sin times ``m(mscale) / m(mscale_all_dim)``."""
    freqs = _yarn_table(cfg.qk_rope_head_dim, cfg.rope_theta, cfg.rope_factor,
                        cfg.beta_fast, cfg.beta_slow,
                        cfg.original_max_positions, t.device)
    mult = (yarn_mscale(cfg.rope_factor, cfg.mscale)
            / yarn_mscale(cfg.rope_factor, cfg.mscale_all_dim))
    return rotate(t, positions, freqs, mult)


def _mla_query(p: MLAttention, cfg, x, positions):
    """x (B, S, d) → (q_C (B, S, H, qk_nope), q_R (B, S, H, qk_rope) roped)."""
    b, s, _ = x.shape
    q = _proj(p.wq, x).reshape(b, s, cfg.n_heads, cfg.qk_head_dim)
    q_c, q_r = q.split([cfg.qk_nope_head_dim, cfg.qk_rope_head_dim], -1)
    return q_c, mla_rope(cfg, q_r, positions)


def mla_latent(p: MLAttention, cfg, x, positions):
    """x (B, S, d) → (c (B, S, kv_lora_rank) RMS-normed, k_R (B, S,
    qk_rope) roped): what the decode cache holds."""
    c, k_r = _proj(p.wkv_a, x).split(
        [cfg.kv_lora_rank, cfg.qk_rope_head_dim], -1)
    c = rmsnorm(p.kv_norm, c, cfg.norm_eps)
    return c, mla_rope(cfg, k_r[:, :, None], positions)[:, :, 0]


def mla_attend(p: MLAttention, cfg, x, positions):
    """Full-sequence causal MLA (training / prefill). x: (B, S, D) →
    (y (B, S, D), (c, k_R)), the latent for the cache. The core is the
    hand-written kernel (``kernels/mla_attention.py``) for CUDA bf16
    operands, which raises on shapes it does not take; ``_sdpa`` (or
    ``_blockwise_sdpa`` past ``dense_attn_max``) for any other."""
    b, s, _ = x.shape
    h, dn, dv = cfg.n_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    with span("lm.mla"):
        q_c, q_r = _mla_query(p, cfg, x, positions)
        c, k_r = mla_latent(p, cfg, x, positions)
        k_c, v = _proj(p.wkv_b, c).reshape(b, s, h, dn + dv).split([dn, dv], -1)
        q = torch.cat([q_c, q_r], -1)
        k = torch.cat([k_c, k_r[:, :, None].expand(b, s, h, -1)], -1)
        pos2 = _broadcast_positions(positions, x.shape[:2])
        with span("lm.mla.core"):
            if q.is_cuda and q.dtype == torch.bfloat16:
                out = mla_attention.mla_attention(q, k, v, pos2, mla_scale(cfg))
            elif s <= cfg.dense_attn_max:
                out = _sdpa(q, k, v, _mask(pos2, pos2, "causal", None),
                            mla_scale(cfg))
            else:
                out = _blockwise_sdpa(q, k, v, pos2, pos2, "causal", None,
                                      mla_scale(cfg), cfg.kv_block)
        y = F.linear(out.reshape(b, s, h * dv), p.wo.weight.to(x.dtype))
    return y, (c, k_r)


def init_mla_cache(batch, cache_len, kv_lora_rank, rope_dim,
                   dtype=torch.bfloat16, device=None):
    """An empty latent cache: ``c`` (B, S, kv_lora_rank), ``kr`` (B, S,
    rope_dim), ``pos`` (B, S) -1."""
    return {
        "c": torch.zeros((batch, cache_len, kv_lora_rank), dtype=dtype,
                         device=device),
        "kr": torch.zeros((batch, cache_len, rope_dim), dtype=dtype,
                          device=device),
        "pos": torch.full((batch, cache_len), -1, dtype=torch.int32,
                          device=device),
    }


def mla_cache_from_prefill(c, k_r, positions, cache_len):
    """The prefill's latent (B, S, ·) in the first S of ``cache_len`` slots
    (no window: MLA attends to every earlier position)."""
    s = c.shape[1]
    if s > cache_len:
        raise ValueError(f"a prefill of {s} positions into a latent cache of "
                         f"{cache_len}")
    pos2 = _broadcast_positions(positions, c.shape[:2]).to(torch.int32)
    pad = cache_len - s
    return {"c": F.pad(c, (0, 0, 0, pad)), "kr": F.pad(k_r, (0, 0, 0, pad)),
            "pos": F.pad(pos2, (0, pad), value=-1)}


def mla_decode_attend(p: MLAttention, cfg, x, cache, pos):
    """One-token MLA against the latent cache: x (B, 1, D); pos (B,) or
    (B, 1). Writes the token's ``c``, ``k_R`` and position into slot ``pos
    % cache_len`` in place. ``wkv_b``'s key half is absorbed into the query
    (scores against ``c`` itself) and its value half applied to the
    attended latent, so the cache stays the latent. Returns
    ``(y (B, 1, D), cache)``."""
    b = x.shape[0]
    h, dn, dv = cfg.n_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    positions = pos[:, None] if pos.ndim == 1 else pos
    with span("lm.mla"):
        q_c, q_r = _mla_query(p, cfg, x, positions)
        c_new, kr_new = mla_latent(p, cfg, x, positions)
        pos_b = positions[:, 0]
        slot = (pos_b % cache["c"].shape[1]).long()
        bidx = torch.arange(b, device=x.device)
        cache["c"][bidx, slot] = c_new[:, 0].to(cache["c"].dtype)
        cache["kr"][bidx, slot] = kr_new[:, 0].to(cache["kr"].dtype)
        cache["pos"][bidx, slot] = pos_b.to(torch.int32)
        w_b = p.wkv_b.weight.to(x.dtype).reshape(h, dn + dv, -1)
        q_lat = torch.einsum("bhd,hdr->bhr", q_c[:, 0], w_b[:, :dn])
        q_r = q_r[:, 0].to(cache["kr"].dtype)
        with span("lm.mla.core"):
            s = (_dot_f32(q_lat.to(cache["c"].dtype), cache["c"].transpose(1, 2))
                 + _dot_f32(q_r, cache["kr"].transpose(1, 2))) * mla_scale(cfg)
            ok = (cache["pos"] >= 0) & (cache["pos"] <= pos_b[:, None])
            s = torch.where(ok[:, None], s, NEG_INF)          # (B, H, S)
            m = s.amax(-1, keepdim=True)
            w = torch.exp(s - m)
            lat = _dot_f32(w.to(cache["c"].dtype), cache["c"])  # (B, H, r)
            lat = lat / torch.clamp(w.sum(-1, keepdim=True), min=1e-30)
        out = torch.einsum("bhr,hvr->bhv", lat.to(x.dtype), w_b[:, dn:])
        y = F.linear(out.reshape(b, 1, h * dv), p.wo.weight.to(x.dtype))
    return y, cache


# ---------------------------------------------------------------------------
# Head-parallel attention and flash-decode over a mesh
# ---------------------------------------------------------------------------


def head_plan(n_heads: int, n_kv_heads: int, model: int) -> list[tuple[int, int]]:
    """Per ``model`` rank ``c``: the K/V heads ``[lo, hi)`` that its query
    heads ``[c·H/m, (c+1)·H/m)`` read (query head h reads K/V head h // g).
    Raises ``NotImplementedError`` unless ``model`` divides the query
    heads and the grouping maps a rank's heads onto whole K/V heads."""
    hm, g = n_heads // model, n_heads // n_kv_heads
    if n_heads % model or (hm % g and g % hm):
        raise NotImplementedError(
            f"{n_heads} query heads in groups of {g} over {model} model "
            "ranks: head-parallel attention needs model | n_heads and whole "
            "K/V heads per rank")
    return [(c * hm // g, ((c + 1) * hm - 1) // g + 1) for c in range(model)]


def kv_heads_split(n_kv_heads: int, model: int) -> bool:
    """Whether the K/V heads' ranges are the ``model`` shards of ``wk`` /
    ``wv`` (else the projections are also gathered over ``model``)."""
    return n_kv_heads % model == 0


def kv_extra_gather(n_kv_heads: int, model: int, prefix: str = "") -> dict:
    """``sharding.gather_params``'s ``extra`` for an attention block: when
    the K/V heads do not split over ``model`` (``kv_heads_split``), ``wk``
    and ``wv`` (and their biases) are gathered over ``model`` too, so a
    rank can project the heads its queries read."""
    if kv_heads_split(n_kv_heads, model):
        return {}
    return {f"{prefix}{w}.{t}": (MODEL,) for w in ("wk", "wv")
            for t in ("weight", "bias")}


def _kv_rows(p: Attention, lo: int, hi: int, head_dim: int) -> Attention:
    """A view of ``p`` (whole ``wk`` / ``wv``) projecting K/V heads
    ``[lo, hi)`` only."""
    rows = slice(lo * head_dim, hi * head_dim)
    sub = {}
    for name in ("wk", "wv"):
        lin = getattr(p, name)
        sub[f"{name}.weight"] = lin.weight[rows]
        if lin.bias is not None:
            sub[f"{name}.bias"] = lin.bias[rows]
    return module_view(p, sub)


def _local_attention(ps, mesh, n_heads, n_kv_heads, head_dim):
    """Per rank: (its attention view, its query heads, its K/V heads)."""
    m = axis_size(mesh, MODEL)
    plan = head_plan(n_heads, n_kv_heads, m)
    split = kv_heads_split(n_kv_heads, m)
    out = []
    for r, p in enumerate(ps):
        lo, hi = plan[axis_index(mesh, r, MODEL)]
        out.append((p if split else _kv_rows(p, lo, hi, head_dim),
                    n_heads // m, hi - lo))
    return out


def gather_kv_heads(ks, mesh, n_heads: int, n_kv_heads: int, dim: int):
    """Every rank's K (or V) with all ``n_kv_heads`` heads on ``dim``, from
    each rank's own heads (``head_plan``): an all-gather over ``model``
    and, where ranks share a head, one copy of it."""
    m = axis_size(mesh, MODEL)
    full = all_gather(ks, mesh, MODEL, dim)
    if kv_heads_split(n_kv_heads, m):
        return full
    plan = head_plan(n_heads, n_kv_heads, m)
    offs = [0]
    for lo, hi in plan:
        offs.append(offs[-1] + hi - lo)
    idx = [next(offs[c] + j - lo for c, (lo, hi) in enumerate(plan)
                if lo <= j < hi) for j in range(n_kv_heads)]
    return PerRank(t.index_select(dim, torch.tensor(idx, device=t.device))
                   for t in full)


def attend_sharded(ps, hs, positions, *, mesh, n_heads, n_kv_heads, head_dim,
                   rope_theta, kind="causal", window=None, use_rope=True,
                   dense_max_seq=8192, kv_block=512):
    """Head-parallel ``attend`` (training / prefill): each rank runs
    ``attend``'s heads on its slice (``ps[r]`` gathered over ``data``;
    ``hs[r]`` its batch rows, every position) with its query and K/V heads,
    then its rows of the row-parallel ``wo``. Returns (the float32 partial
    sums, for the caller to reduce over ``model``; each rank's (k, v) of its
    K/V heads)."""
    ys, kvs = [], []
    for (p, hq, hkv), h in zip(_local_attention(ps, mesh, n_heads, n_kv_heads,
                                                head_dim), hs):
        out, kv = _attend_heads(
            p, h, positions.to(h.device), n_heads=hq, n_kv_heads=hkv,
            head_dim=head_dim, rope_theta=rope_theta, kind=kind, window=window,
            use_rope=use_rope, dense_max_seq=dense_max_seq, kv_block=kv_block)
        ys.append(linear_f32(out, p.wo.weight))
        kvs.append(kv)
    return ys, kvs


def decode_attend_sharded(ps, xs, caches, pos, *, mesh, n_heads, n_kv_heads,
                          head_dim, rope_theta, window, use_rope=True):
    """One-token decode against a cache split on ``S`` over ``model`` (the
    reference's shard_map; per-rank lists, ``ps`` gathered over ``data``).

    Each rank projects its heads; an all-gather over ``model`` gives every
    rank all of q and the new K/V for ``_flash_decode``. Each rank
    multiplies its heads of the result by its ``wo`` rows. Returns
    (float32 partial sums, for the caller to reduce over ``model``; the
    caches, updated in place)."""
    local = _local_attention(ps, mesh, n_heads, n_kv_heads, head_dim)
    qs, kns, vns = [], [], []
    for (p, hq, hkv), x, pb in zip(local, xs, pos):
        q, k, v = _project_qkv(p, x, hq, hkv, head_dim, pb[:, None],
                               rope_theta, use_rope)
        qs.append(q)
        kns.append(k)
        vns.append(v)
    qs = all_gather(qs, mesh, MODEL, 2)
    kns = gather_kv_heads(kns, mesh, n_heads, n_kv_heads, 2)
    vns = gather_kv_heads(vns, mesh, n_heads, n_kv_heads, 2)
    outs = _flash_decode(qs, kns, vns, caches, pos, mesh=mesh,
                         head_dim=head_dim, window=window)
    ys = []
    for r, ((p, hq, _), x, out) in enumerate(zip(local, xs, outs)):
        c = axis_index(mesh, r, MODEL)
        out = out[:, c * hq:(c + 1) * hq].reshape(x.shape[0], 1, hq * head_dim)
        ys.append(linear_f32(out.to(x.dtype), p.wo.weight))
    return ys, caches


def _flash_decode(qs, kns, vns, caches, pos, *, mesh, head_dim, window):
    """The reference's shard_map body on every rank: ``qs[r]`` (B, 1, H,
    Dh) and ``kns[r]`` / ``vns[r]`` (B, 1, Hkv, Dh) its batch rows with
    every head. A rank writes the new K/V, and the position, into slot
    ``pos % cache_len`` only if that slot lies in its slice of the cache
    (the reference's ``mine`` mask), then scores all heads over its slice
    (``_decode_attend_local``); the partials combine with a ``pmax`` of
    ``m`` and ``psum``s of ``l·corr`` and ``acc·corr`` over ``model``.
    Returns each rank's attention output (B, H, Dh), float32."""
    scale = head_dim ** -0.5
    accs, ms, ls = [], [], []
    for r, cache in enumerate(caches):
        ck, cv, cp, pb = cache["k"], cache["v"], cache["pos"], pos[r]
        s_local = ck.shape[2]
        cache_len = s_local * axis_size(mesh, MODEL)
        slot = (pb % cache_len).long() - axis_index(mesh, r, MODEL) * s_local
        mine = (slot >= 0) & (slot < s_local)
        slot = slot.clamp(0, s_local - 1)
        bidx = torch.arange(ck.shape[0], device=ck.device)
        ck[bidx, :, slot] = torch.where(mine[:, None, None],
                                        kns[r][:, 0].to(ck.dtype), ck[bidx, :, slot])
        cv[bidx, :, slot] = torch.where(mine[:, None, None],
                                        vns[r][:, 0].to(cv.dtype), cv[bidx, :, slot])
        cp[bidx, slot] = torch.where(mine, pb.to(torch.int32), cp[bidx, slot])
        cpos = cp
        if window is not None:
            cpos = torch.where(cp > (pb[:, None] - window), cp, -1)
        acc, m, l = _decode_attend_local(qs[r][:, 0], ck, cv, cpos, pb, scale)
        accs.append(acc)
        ms.append(m)
        ls.append(l)
    m_g = pmax(ms, mesh, MODEL)
    corr = [torch.exp(m - mg) for m, mg in zip(ms, m_g)]
    l_g = psum([l * c for l, c in zip(ls, corr)], mesh, MODEL)
    acc_g = psum([a * c[..., None] for a, c in zip(accs, corr)], mesh, MODEL)
    return [(a / torch.clamp(l, min=1e-30)[..., None]).flatten(1, 2)
            for a, l in zip(acc_g, l_g)]


def decode_attend_stationary(ps, hs, caches, pos, *, policy, n_heads,
                             n_kv_heads, head_dim, rope_theta, window,
                             use_rope=True):
    """One-token decode with the weights stationary (``Policy.decode_mode``):
    ``hs[r]`` (rows, 1, d/|data|) the rank's ``data`` slice of the normed
    residual, ``ps[r]`` rank r's own shards (nothing gathered).

    Each rank multiplies its slice by its rows of ``wq`` / ``wk`` / ``wv``
    (one float32 partial over ``data``), ``sharding.psum_to_batch`` sums
    the partials into its batch rows, and one all_gather over ``model``
    gives it every head of q and of the new K/V; qk-norm and rope follow,
    then ``_flash_decode`` against the cache (the cache's layout is
    unchanged). The rank's ``wo`` columns of the output, gathered over the
    batch rows, meet its ``wo`` shard. Returns (the (rows, 1, d/|data|)
    float32 partial sums, for the caller to reduce over ``model``; the
    caches, updated in place)."""
    mesh = policy.mesh
    m = axis_size(mesh, MODEL)
    widths = [n * head_dim // m for n in (n_heads, n_kv_heads, n_kv_heads)]
    parts = psum_to_batch([torch.cat([linear_f32(h, lin.weight)
                                      for lin in (p.wq, p.wk, p.wv)], -1)
                           for p, h in zip(ps, hs)], policy)
    local = []
    for p, t in zip(ps, parts):
        t = [u if lin.bias is None else u + lin.bias.float()
             for u, lin in zip(t.split(widths, -1), (p.wq, p.wk, p.wv))]
        local.append(torch.cat(t, -1).to(hs[0].dtype))
    qs, kns, vns = [], [], []
    for p, t, pb in zip(ps, all_gather(local, mesh, MODEL, -1), pos):
        b = t.shape[0]
        q, k, v = (u.reshape(b, 1, n, head_dim) for u, n in zip(
            t.reshape(b, 1, m, -1).split(widths, -1),
            (n_heads, n_kv_heads, n_kv_heads)))
        q, k = _finish_qk(p, q, k, pb[:, None], rope_theta, use_rope)
        qs.append(q)
        kns.append(k)
        vns.append(v)
    outs = _flash_decode(qs, kns, vns, caches, pos, mesh=mesh,
                         head_dim=head_dim, window=window)
    outs = [o.reshape(o.shape[0], 1, -1).chunk(m, -1)[axis_index(mesh, r, MODEL)]
            .to(hs[0].dtype) for r, o in enumerate(outs)]
    return [linear_f32(o, p.wo.weight)
            for p, o in zip(ps, gather_batch(outs, policy))], caches


# ---------------------------------------------------------------------------
# Cross-attention (the encoder-decoder family)
# ---------------------------------------------------------------------------


def _cross_heads(p: Attention, x, enc_kv, *, n_heads, head_dim):
    """``cross_attend`` up to ``wo``: the heads' outputs (B, S, H·Dh)."""
    return _cross_sdpa(F.linear(x, p.wq.weight.to(x.dtype)), enc_kv,
                       n_heads=n_heads, head_dim=head_dim)


def _cross_sdpa(q, enc_kv, *, n_heads, head_dim):
    """Projected queries (B, S, H·Dh) against the encoder K/V, every
    position allowed: (B, S, H·Dh)."""
    b, s, _ = q.shape
    k, v = enc_kv
    mask = torch.ones((b, s, k.shape[1]), dtype=torch.bool, device=q.device)
    return _sdpa(q.reshape(b, s, n_heads, head_dim), k, v, mask,
                 head_dim ** -0.5).reshape(b, s, n_heads * head_dim)


def cross_attend(p: Attention, x, enc_kv, *, n_heads, n_kv_heads, head_dim):
    """Cross-attention of x (B, S, D) to precomputed encoder K/V, each
    (B, S_enc, Hkv, Dh): dense ``_sdpa`` with every encoder position
    allowed, no rope (whisper's decoder). ``n_kv_heads`` is the K/V's head
    count (the reference's signature; the tensors carry it too)."""
    out = _cross_heads(p, x, enc_kv, n_heads=n_heads, head_dim=head_dim)
    return F.linear(out, p.wo.weight.to(x.dtype))


def cross_attend_sharded(ps, hs, enc_kvs, *, head_dim):
    """Head-parallel ``cross_attend``: rank r's query heads (``ps[r]``'s
    ``wq`` rows, gathered over ``data``) against its heads of the encoder
    K/V (``enc_kvs[r]``, heads on ``model``), then its ``wo`` rows. Returns
    the float32 partial sums, for the caller to reduce over ``model``."""
    return [linear_f32(_cross_heads(p, h, kv, n_heads=kv[0].shape[2],
                                    head_dim=head_dim), p.wo.weight)
            for p, h, kv in zip(ps, hs, enc_kvs)]


def cross_attend_stationary(ps, hs, enc_kvs, *, policy, head_dim):
    """One decode token's cross-attention with the weights stationary:
    ``hs[r]`` (rows, 1, d/|data|) the rank's ``data`` slice of the normed
    residual, ``ps[r]`` rank r's shards. The ``wq`` partials are summed
    into the rank's batch rows of its heads (``psum_to_batch``), which
    meet its heads of the encoder K/V (``enc_kvs[r]``, from the cache);
    the output, gathered over the batch rows, meets its ``wo`` shard.
    Returns the float32 partial sums, for the caller to reduce over
    ``model``."""
    qs = psum_to_batch([linear_f32(h, p.wq.weight) for p, h in zip(ps, hs)],
                       policy)
    outs = [_cross_sdpa(q.to(h.dtype), kv, n_heads=kv[0].shape[2],
                        head_dim=head_dim)
            for q, h, kv in zip(qs, hs, enc_kvs)]
    return [linear_f32(o, p.wo.weight)
            for p, o in zip(ps, gather_batch(outs, policy))]


def encoder_kv(p: Attention, enc_out, *, n_kv_heads, head_dim):
    """The encoder output (B, S_enc, D) projected by ``wk`` / ``wv`` into
    the cross-attention's K and V, each (B, S_enc, Hkv, Dh)."""
    b, s, _ = enc_out.shape
    k = F.linear(enc_out, p.wk.weight.to(enc_out.dtype))
    v = F.linear(enc_out, p.wv.weight.to(enc_out.dtype))
    return (k.reshape(b, s, n_kv_heads, head_dim),
            v.reshape(b, s, n_kv_heads, head_dim))
