"""RWKV-6 "Finch" (arXiv:2404.05892): data-dependent decay, attention-free.
The port's ``repro.models.rwkv6``.

TimeMix with DDLERP token-shift mixing and LoRA-modulated per-channel
decay, the matrix-state recurrence (``models/recurrence.py``), a per-head
output norm; ChannelMix with squared ReLU. LayerNorms as in the reference.

Decode state per layer: {"tm_shift": (B, d), "cm_shift": (B, d), "wkv":
(B, H, Dk, Dv) float32} — O(d + H·Dk·Dv) per token, no KV cache. An empty
state keeps the shifts in bf16 whatever the compute dtype, as the
reference's ``init_rwkv_state`` does.

On a mesh (``rwkv_block_sharded``, per-rank lists) the block computes with
heads on ``model``: ``w_r`` / ``w_k`` / ``w_v`` / ``w_g`` are
column-parallel in contiguous head blocks, so the decay, ``u``, the
recurrence, the group norm and the gate are local, and ``w_o`` is
row-parallel. The stored state keeps the reference's layout (``wkv``'s Dv
and the shifts' d on ``model``): ``wkv`` moves between the two layouts by
an ``all_to_all`` on entry and exit, the shifts are all-gathered on entry
and each rank keeps its d-slice of the last token on exit. The channel
mix meets its row-parallel ``w_v`` and column-parallel ``w_r`` in a
``psum_scatter`` over d.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.launch.mesh import axis_index, axis_size
from repro_torch.models.common import (
    LayerNorm,
    empty_linear,
    init_linear_,
    layernorm,
    linear_f32,
    truncated_normal_,
)
from repro_torch.models.recurrence import (
    chunked_matrix_recurrence,
    matrix_recurrence_step,
)
from repro_torch.sharding import (
    MODEL,
    all_gather,
    all_to_all,
    module_view,
    psum,
    psum_scatter,
)

LORA_R = 64
DDLERP_R = 32


class TimeMix(nn.Module):
    """The reference's leaves: ``mu_x`` (d,), ``mu`` (5, d) (the w, k, v,
    r, g bases), ``ddlerp_a`` (d, 5·32), ``ddlerp_b`` (5, 32, d), ``w0``
    (d,), ``lora_w_a`` (d, 64), ``lora_w_b`` (64, d), ``u`` (H, Dh) as
    plain parameters in the reference's layout; ``w_r``, ``w_k``, ``w_v``,
    ``w_g``, ``w_o`` as ``nn.Linear``; ``out_norm`` a ``LayerNorm`` over
    (H, Dh)."""

    def __init__(self, d: int, n_heads: int, head_dim: int, device=None):
        super().__init__()

        def empty(*shape):
            return nn.Parameter(torch.empty(shape, device=device))

        self.mu_x = nn.Parameter(torch.zeros(d, device=device))
        self.mu = nn.Parameter(torch.zeros(5, d, device=device))
        self.ddlerp_a = empty(d, 5 * DDLERP_R)
        self.ddlerp_b = empty(5, DDLERP_R, d)
        self.w0 = empty(d)
        self.lora_w_a = empty(d, LORA_R)
        self.lora_w_b = empty(LORA_R, d)
        self.u = empty(n_heads, head_dim)
        for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
            setattr(self, name, empty_linear(d, d, device=device))
        self.out_norm = LayerNorm((n_heads, head_dim), device)


class ChannelMix(nn.Module):
    """``mu_k``, ``mu_r`` (d,) and the ``nn.Linear``s ``w_k`` (d → d_ff),
    ``w_v`` (d_ff → d), ``w_r`` (d → d)."""

    def __init__(self, d: int, d_ff: int, device=None):
        super().__init__()
        self.mu_k = nn.Parameter(torch.zeros(d, device=device))
        self.mu_r = nn.Parameter(torch.zeros(d, device=device))
        self.w_k = empty_linear(d, d_ff, device=device)
        self.w_v = empty_linear(d_ff, d, device=device)
        self.w_r = empty_linear(d, d, device=device)


class RWKVBlock(nn.Module):
    """``ln1``, ``ln2`` and ``rwkv`` = {"tm": TimeMix, "cm": ChannelMix}."""

    def __init__(self, d: int, d_ff: int, n_heads: int, head_dim: int,
                 device=None):
        super().__init__()
        self.ln1 = LayerNorm(d, device)
        self.ln2 = LayerNorm(d, device)
        self.rwkv = nn.ModuleDict({"tm": TimeMix(d, n_heads, head_dim, device),
                                   "cm": ChannelMix(d, d_ff, device)})


@torch.no_grad()
def init_rwkv_block(gen: torch.Generator, d: int, d_ff: int, n_heads: int,
                    head_dim: int) -> RWKVBlock:
    """An ``RWKVBlock`` on the generator's device with the reference's
    distributions (``u`` uniform in [0, 0.5), ``w0`` a per-head linspace
    from -6 to -1, the LoRA B factors 0.01·normal, mixes at zero)."""
    p = RWKVBlock(d, d_ff, n_heads, head_dim, device=gen.device)
    tm, cm = p.rwkv["tm"], p.rwkv["cm"]
    tm.u.uniform_(0.0, 0.5, generator=gen)
    truncated_normal_(tm.ddlerp_a, gen, d ** -0.5)
    tm.ddlerp_b.normal_(0.0, 0.01, generator=gen)
    tm.w0.copy_(torch.linspace(-6.0, -1.0, head_dim,
                               device=gen.device).repeat(n_heads))
    truncated_normal_(tm.lora_w_a, gen, d ** -0.5)
    tm.lora_w_b.normal_(0.0, 0.01, generator=gen)
    for lin in (tm.w_r, tm.w_k, tm.w_v, tm.w_g, tm.w_o, cm.w_k, cm.w_v, cm.w_r):
        init_linear_(gen, lin)
    return p


def _lin(lin: nn.Linear, x):
    return F.linear(x, lin.weight.to(x.dtype))


def _group_norm(p: LayerNorm, x):
    """Per-head layer norm of (…, H, Dh) (population variance)."""
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * p.scale + p.bias


def _ddlerp(p: TimeMix, x, xx):
    """Data-dependent lerp producing the 5 mixed inputs (w, k, v, r, g)."""
    base = x + xx * p.mu_x.to(x.dtype)
    lo = torch.tanh(base @ p.ddlerp_a.to(x.dtype))
    lo = lo.reshape(*x.shape[:-1], 5, DDLERP_R)
    adj = torch.einsum("...fr,frd->...fd", lo, p.ddlerp_b.to(x.dtype))
    mixed = x[..., None, :] + xx[..., None, :] * (p.mu.to(x.dtype) + adj)
    return mixed.unbind(-2)                               # each (…, d)


def _decay(p: TimeMix, xw, n_heads, head_dim):
    """Per-channel data-dependent decay w_t ∈ (0, 1), float32."""
    lo = torch.tanh(xw @ p.lora_w_a.to(xw.dtype)) @ p.lora_w_b.to(xw.dtype)
    w = torch.exp(-torch.exp(p.w0.float() + lo.float()))
    return w.reshape(*xw.shape[:-1], n_heads, head_dim)


def _gated_heads(p: TimeMix, o, g):
    """Output norm in float32 and the silu gate: (…, H·Dh), ahead of
    ``w_o``."""
    o = _group_norm(p.out_norm, o.float()).to(g.dtype)
    return o.reshape(g.shape) * F.silu(g)


def _timemix_heads_seq(p: TimeMix, x, shift_in, s0, *, n_heads, head_dim,
                       chunk):
    """``timemix_seq`` up to ``w_o``: (gated heads (B, T, H·Dh), (last_x,
    sT))."""
    b, t, _ = x.shape
    prev = torch.cat([shift_in[:, None].to(x.dtype), x[:, :-1]], dim=1)
    xw, xk, xv, xr, xg = _ddlerp(p, x, prev - x)
    heads = (b, t, n_heads, head_dim)
    r = _lin(p.w_r, xr).reshape(heads)
    k = _lin(p.w_k, xk).reshape(heads)
    v = _lin(p.w_v, xv).reshape(heads)
    w = _decay(p, xw, n_heads, head_dim)                  # (B,T,H,Dh) float32
    o, sT = chunked_matrix_recurrence(
        r.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1),
        w.transpose(0, 1), p.u, s0, chunk=chunk)
    return _gated_heads(p, o.transpose(0, 1), _lin(p.w_g, xg)), (x[:, -1], sT)


def _timemix_heads_step(p: TimeMix, x, shift_in, s, *, n_heads, head_dim):
    """``timemix_step`` up to ``w_o``."""
    b = x.shape[0]
    xw, xk, xv, xr, xg = _ddlerp(p, x, shift_in.to(x.dtype) - x)
    heads = (b, n_heads, head_dim)
    o, sT = matrix_recurrence_step(
        _lin(p.w_r, xr).reshape(heads), _lin(p.w_k, xk).reshape(heads),
        _lin(p.w_v, xv).reshape(heads), _decay(p, xw, n_heads, head_dim),
        p.u, s)
    return _gated_heads(p, o, _lin(p.w_g, xg)), (x, sT)


def timemix_seq(p: TimeMix, x, shift_in, s0, *, n_heads, head_dim, chunk):
    """x: (B, T, d); shift_in: (B, d), the last token of the previous
    segment; s0: (B, H, Dh, Dh). Returns (out, (last_x, sT))."""
    o, state = _timemix_heads_seq(p, x, shift_in, s0, n_heads=n_heads,
                                  head_dim=head_dim, chunk=chunk)
    return _lin(p.w_o, o), state


def timemix_step(p: TimeMix, x, shift_in, s, *, n_heads, head_dim):
    """Single-token decode. x: (B, d)."""
    o, state = _timemix_heads_step(p, x, shift_in, s, n_heads=n_heads,
                                   head_dim=head_dim)
    return _lin(p.w_o, o), state


def _channelmix_parts(p: ChannelMix, x, xx):
    """(squared-ReLU keys (…, d_ff), receptance logits (…, d)), ahead of
    ``w_v`` and the sigmoid."""
    xk = x + xx * p.mu_k.to(x.dtype)
    xr = x + xx * p.mu_r.to(x.dtype)
    return torch.square(F.relu(_lin(p.w_k, xk))), _lin(p.w_r, xr)


def _channelmix(p: ChannelMix, x, xx):
    k, r = _channelmix_parts(p, x, xx)
    return torch.sigmoid(r) * _lin(p.w_v, k)


def channelmix_seq(p: ChannelMix, x, shift_in):
    """x: (B, T, d) → (out, last_x)."""
    prev = torch.cat([shift_in[:, None].to(x.dtype), x[:, :-1]], dim=1)
    return _channelmix(p, x, prev - x), x[:, -1]


def channelmix_step(p: ChannelMix, x, shift_in):
    """x: (B, d) → (out, x)."""
    return _channelmix(p, x, shift_in.to(x.dtype) - x), x


def rwkv_block_seq(p: RWKVBlock, x, state, *, n_heads, head_dim, chunk):
    """state: {"tm_shift", "cm_shift", "wkv"}; x: (B, T, d)."""
    o, (tm_shift, wkv) = timemix_seq(
        p.rwkv["tm"], layernorm(p.ln1, x), state["tm_shift"], state["wkv"],
        n_heads=n_heads, head_dim=head_dim, chunk=chunk)
    x = x + o
    o, cm_shift = channelmix_seq(p.rwkv["cm"], layernorm(p.ln2, x),
                                 state["cm_shift"])
    return x + o, {"tm_shift": tm_shift, "cm_shift": cm_shift, "wkv": wkv}


def rwkv_block_step(p: RWKVBlock, x, state, *, n_heads, head_dim):
    """x: (B, d), a single token."""
    o, (tm_shift, wkv) = timemix_step(
        p.rwkv["tm"], layernorm(p.ln1, x), state["tm_shift"], state["wkv"],
        n_heads=n_heads, head_dim=head_dim)
    x = x + o
    o, cm_shift = channelmix_step(p.rwkv["cm"], layernorm(p.ln2, x),
                                  state["cm_shift"])
    return x + o, {"tm_shift": tm_shift, "cm_shift": cm_shift, "wkv": wkv}


def rwkv_state_shapes(batch, d, n_heads, head_dim, dtype=torch.bfloat16):
    """``(shape, dtype)`` of each state tensor: the shifts in ``dtype``,
    ``wkv`` in float32."""
    return {"tm_shift": ((batch, d), dtype), "cm_shift": ((batch, d), dtype),
            "wkv": ((batch, n_heads, head_dim, head_dim), torch.float32)}


def init_rwkv_state(batch, d, n_heads, head_dim, dtype=torch.bfloat16,
                    device=None):
    """A zero state (the reference's: bf16 shifts, float32 ``wkv``)."""
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, (shape, dt) in rwkv_state_shapes(
                batch, d, n_heads, head_dim, dtype).items()}


# ---------------------------------------------------------------------------
# On a mesh: heads on model
# ---------------------------------------------------------------------------


def _head_view(p: TimeMix, c: int, m: int) -> TimeMix:
    """Model rank ``c``'s view of a (replicated-vector, column-parallel)
    ``TimeMix``: ``u``, ``w0``, ``lora_w_b``'s columns and ``out_norm``
    cut to its heads ``[c·H/m, (c+1)·H/m)``, the ones its ``w_r`` / ``w_k``
    / ``w_v`` / ``w_g`` rows produce."""
    hm, dh = p.u.shape[0] // m, p.u.shape[1]
    heads, chans = slice(c * hm, (c + 1) * hm), slice(c * hm * dh,
                                                      (c + 1) * hm * dh)
    return module_view(p, {"u": p.u[heads], "w0": p.w0[chans],
                           "lora_w_b": p.lora_w_b[:, chans],
                           "out_norm.scale": p.out_norm.scale[heads],
                           "out_norm.bias": p.out_norm.bias[heads]})


def _shifted(x, shift, decode: bool):
    """The previous token of every position: ``shift`` then ``x[:, :-1]``
    (a sequence), or ``shift`` alone (one decode token); (B, T, d)."""
    prev = shift[:, None].to(x.dtype)
    return prev if decode else torch.cat([prev, x[:, :-1]], dim=1)


def rwkv_block_sharded(ps, xs, states, *, mesh, n_heads, head_dim, chunk,
                       decode=False, sp=False):
    """``rwkv_block_seq`` / ``rwkv_block_step`` (``decode``: one token, x
    (B, 1, d)) on every rank. ``ps[r]``: rank r's block, gathered over
    ``data``; ``xs[r]``: its residual rows, split on the sequence over
    ``model`` when ``sp`` (gathered here around each mix, which needs the
    whole sequence); ``states[r]``: its state in the stored layout (wkv
    (B, H, Dk, Dv/m), shifts (B, d/m)), or None in training (a zero state,
    never stored). Returns (xs, per-rank new states in the stored layout,
    or None). Collectives: all_gathers of the two shifts and all_to_alls
    of ``wkv`` in and out (with a state); the ``w_o`` reduction and the
    channel mix's ``psum_scatter`` over d and all_gather over d (under
    ``sp`` an all_gather of each mix's input on the sequence, a
    reduce-scatter of ``w_o`` on the sequence and an all_to_all from d to
    the sequence in place of the last all_gather)."""
    m = axis_size(mesh, MODEL)
    hm = n_heads // m
    cs = [axis_index(mesh, r, MODEL) for r in range(len(xs))]
    train = states is None

    def whole(key, hs):
        if train:
            return [torch.zeros(h.shape[0], h.shape[-1], dtype=torch.bfloat16,
                                device=h.device) for h in hs]
        return all_gather([st[key] for st in states], mesh, MODEL, -1)

    # time mix, heads on model
    hs = [layernorm(p.ln1, x) for p, x in zip(ps, xs)]
    if sp:
        hs = all_gather(hs, mesh, MODEL, 1)
    shifts = whole("tm_shift", hs)
    if train:
        s0s = [torch.zeros(h.shape[0], hm, head_dim, head_dim,
                           dtype=torch.float32, device=h.device) for h in hs]
    else:
        s0s = all_to_all([st["wkv"] for st in states], mesh, MODEL, 1, 3)
    ys, tm_last, sTs = [], [], []
    for p, h, sh, s0, c in zip(ps, hs, shifts, s0s, cs):
        tm = _head_view(p.rwkv["tm"], c, m)
        kw = dict(n_heads=hm, head_dim=head_dim)
        if decode:
            o, (_, sT) = _timemix_heads_step(tm, h[:, 0], sh, s0, **kw)
            o = o[:, None]
        else:
            o, (_, sT) = _timemix_heads_seq(tm, h, sh, s0, chunk=chunk, **kw)
        ys.append(linear_f32(o, tm.w_o.weight))
        tm_last.append(h[:, -1].chunk(m, -1)[c])
        sTs.append(sT)
    ys = psum_scatter(ys, mesh, MODEL, 1) if sp else psum(ys, mesh, MODEL)
    xs = [x + y.to(x.dtype) for x, y in zip(xs, ys)]

    # channel mix: w_k and w_r column-parallel, w_v row-parallel
    hs = [layernorm(p.ln2, x) for p, x in zip(ps, xs)]
    if sp:
        hs = all_gather(hs, mesh, MODEL, 1)
    kvs, rs, cm_last = [], [], []
    for p, h, sh, c in zip(ps, hs, whole("cm_shift", hs), cs):
        cm = p.rwkv["cm"]
        k, r_ = _channelmix_parts(cm, h, _shifted(h, sh, decode) - h)
        kvs.append(linear_f32(k, cm.w_v.weight))
        rs.append(r_)
        cm_last.append(h[:, -1].chunk(m, -1)[c])
    kvs = psum_scatter(kvs, mesh, MODEL, -1)
    os_ = [torch.sigmoid(r_) * kv.to(r_.dtype) for r_, kv in zip(rs, kvs)]
    os_ = (all_to_all(os_, mesh, MODEL, 1, -1) if sp
           else all_gather(os_, mesh, MODEL, -1))
    xs = [x + o for x, o in zip(xs, os_)]
    if train:
        return xs, None
    wkvs = all_to_all(sTs, mesh, MODEL, 3, 1)
    return xs, [{"tm_shift": a, "cm_shift": b, "wkv": w}
                for a, b, w in zip(tm_last, cm_last, wkvs)]
