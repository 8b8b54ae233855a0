"""Griffin / RecurrentGemma (arXiv:2402.19427): RG-LRU + local attention,
1:2. The port's ``repro.models.griffin``.

Recurrent block: gated dual branch — gelu(x·W_y) ⊙ RG-LRU(conv1d(x·W_x)),
projected back by W_o. RG-LRU is a per-channel gated diagonal recurrence:

    r_t = σ(x_t·W_a + b_a)          (recurrence gate)
    i_t = σ(x_t·W_i + b_i)          (input gate)
    log a_t = -c · softplus(Λ) ⊙ r_t             (c = 8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

evaluated by the chunked diagonal engine (``models/recurrence.py``). As in
the reference, the gate projections are full d_rnn × d_rnn linears and
gelu is the tanh form.

Decode state per layer: the conv tail (B, 3, d_rnn) and the LRU's h
(B, d_rnn), both float32.

On a mesh (``recurrent_block_sharded``, per-rank lists) the d_rnn channels
lie on ``model``: ``w_y`` / ``w_x`` are column-parallel, the conv, Λ, the
gate biases and both state tensors are local, the gates ``w_a`` / ``w_i``
take their rows for the rank's channels over the whole d_rnn (so the
conv output is all-gathered over ``model`` first) and ``w_o`` is
row-parallel (float32 partial sums, reduced by the caller). A
weight-stationary decode step (``recurrent_step_stationary``) keeps
``w_y`` / ``w_x`` / ``w_o`` on their ranks and moves activations; the
gates are gathered over ``data`` there too.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import (
    activation,
    empty_linear,
    init_linear_,
    linear_f32,
)
from repro_torch.models.recurrence import chunked_diag_recurrence
from repro_torch.sharding import MODEL, all_gather, gather_batch, psum_to_batch

RG_LRU_C = 8.0
CONV_W = 4


class RGLRU(nn.Module):
    """``w_a``, ``w_i`` (``nn.Linear`` d_rnn → d_rnn), their biases ``b_a``,
    ``b_i`` and ``lam`` (Λ), each (d_rnn,)."""

    def __init__(self, d_rnn: int, device=None):
        super().__init__()
        self.w_a = empty_linear(d_rnn, d_rnn, device=device)
        self.b_a = nn.Parameter(torch.zeros(d_rnn, device=device))
        self.w_i = empty_linear(d_rnn, d_rnn, device=device)
        self.b_i = nn.Parameter(torch.zeros(d_rnn, device=device))
        self.lam = nn.Parameter(torch.empty(d_rnn, device=device))


class RecurrentBlock(nn.Module):
    """``w_y``, ``w_x`` (d → d_rnn), ``w_o`` (d_rnn → d) as ``nn.Linear``;
    ``conv_w`` (4, d_rnn), ``conv_b`` (d_rnn,); ``rglru``."""

    def __init__(self, d: int, d_rnn: int, device=None):
        super().__init__()
        self.w_y = empty_linear(d, d_rnn, device=device)
        self.w_x = empty_linear(d, d_rnn, device=device)
        self.conv_w = nn.Parameter(torch.empty(CONV_W, d_rnn, device=device))
        self.conv_b = nn.Parameter(torch.zeros(d_rnn, device=device))
        self.rglru = RGLRU(d_rnn, device)
        self.w_o = empty_linear(d_rnn, d, device=device)


@torch.no_grad()
def init_recurrent_block(gen: torch.Generator, d: int,
                         d_rnn: int) -> RecurrentBlock:
    """A ``RecurrentBlock`` on the generator's device with the reference's
    distributions: Λ such that a^c ∈ (0.9, 0.999) (the Griffin appendix),
    the conv 0.01·normal, the linears fan-in scaled, biases zero."""
    p = RecurrentBlock(d, d_rnn, device=gen.device)
    lam = torch.empty(d_rnn, device=gen.device).uniform_(0.9, 0.999,
                                                         generator=gen)
    p.rglru.lam.copy_(torch.log(torch.expm1(-torch.log(lam) / RG_LRU_C)))
    p.conv_w.normal_(0.0, 0.01, generator=gen)
    for lin in (p.w_y, p.w_x, p.w_o, p.rglru.w_a, p.rglru.w_i):
        init_linear_(gen, lin)
    return p


def _lin(lin: nn.Linear, x):
    return F.linear(x, lin.weight.to(x.dtype))


def _rglru_coeffs(p: RGLRU, x, x_gate=None):
    """x: (…, d_rnn) → (a, b) of the diagonal recurrence, float32. The
    gates read ``x_gate`` (default ``x``): on a mesh, the whole d_rnn of
    which ``x`` is the rank's channels.

    softplus(Λ) is taken in Λ's dtype (bf16 under bf16 serving), as the
    reference's is; sqrt(1 - a²) goes through expm1 for a near 1."""
    xf = x.float()
    xg = xf if x_gate is None else x_gate.float()
    r = torch.sigmoid(F.linear(xg, p.w_a.weight.float()) + p.b_a.float())
    i = torch.sigmoid(F.linear(xg, p.w_i.weight.float()) + p.b_i.float())
    log_a = -RG_LRU_C * F.softplus(p.lam) * r
    a = torch.exp(log_a)
    mult = torch.sqrt(-torch.expm1(2.0 * log_a))
    return a, mult * (i * xf)


def _causal_conv_seq(p: RecurrentBlock, x, tail):
    """Depthwise causal conv of width 4. x: (B, T, dr); tail: (B, 3, dr),
    the history (float32 state, taken in x's dtype)."""
    full = torch.cat([tail.to(x.dtype), x], dim=1)
    out = sum(full[:, CONV_W - 1 - i: full.shape[1] - i]
              * p.conv_w[CONV_W - 1 - i].to(x.dtype) for i in range(CONV_W))
    return out + p.conv_b.to(x.dtype), full[:, -(CONV_W - 1):]


def _branches(p: RecurrentBlock, x, tail, decode: bool):
    """(gelu(x·W_y), the causal conv of x·W_x, the new conv tail) of a
    sequence x (B, T, d), or of one token x (B, d)."""
    y = activation("gelu")(_lin(p.w_y, x))
    if not decode:
        return (y,) + _causal_conv_seq(p, _lin(p.w_x, x), tail)
    return (y,) + _conv_step(p, _lin(p.w_x, x), tail)


def _conv_step(p: RecurrentBlock, xw, tail):
    """The causal conv of one token xw (B, dr) after its tail (B, 3, dr):
    (the conv output, the new tail)."""
    hist = torch.cat([tail.to(xw.dtype), xw[:, None]], 1)
    conv = sum(hist[:, -1 - i] * p.conv_w[CONV_W - 1 - i].to(xw.dtype)
               for i in range(CONV_W)) + p.conv_b.to(xw.dtype)
    return conv, hist[:, 1:]


def _recur(p: RGLRU, xr, h0, *, chunk, decode: bool, x_gate=None):
    """The RG-LRU over the conv output: (h of every position, float32; the
    last h)."""
    a, b = _rglru_coeffs(p, xr, x_gate)
    if decode:
        h = a * h0.float() + b
        return h, h
    hs, h_t = chunked_diag_recurrence(a.transpose(0, 1), b.transpose(0, 1),
                                      h0.float(), chunk=chunk)
    return hs.transpose(0, 1), h_t


def recurrent_block_seq(p: RecurrentBlock, x, state, *, chunk):
    """x: (B, T, d); state: {"conv": (B, 3, dr), "h": (B, dr)}."""
    y, xr, conv_tail = _branches(p, x, state["conv"], False)
    hs, h_t = _recur(p.rglru, xr, state["h"], chunk=chunk, decode=False)
    return _lin(p.w_o, hs.to(x.dtype) * y), {"conv": conv_tail.float(),
                                            "h": h_t}


def recurrent_block_step(p: RecurrentBlock, x, state):
    """x: (B, d), a single token."""
    y, conv, hist = _branches(p, x, state["conv"], True)
    h, _ = _recur(p.rglru, conv, state["h"], chunk=None, decode=True)
    return _lin(p.w_o, h.to(x.dtype) * y), {"conv": hist.float(), "h": h}


def recurrent_block_sharded(ps, hs, states, *, mesh, chunk, decode=False):
    """``recurrent_block_seq`` / ``_step`` (``decode``: hs (B, 1, d)) on
    every rank: ``ps[r]`` rank r's block (gathered over ``data``), ``hs[r]``
    its normed rows at every position, ``states[r]`` its conv tail (B, 3,
    d_rnn/m) and h (B, d_rnn/m), or None in training (zeros). One
    all_gather over ``model`` (the conv output, for the gates). Returns
    (the ``w_o`` float32 partial sums, for the caller to reduce over
    ``model``; per-rank new states, or None in training)."""
    if states is None:
        states = [init_griffin_state(h.shape[0], p.conv_b.shape[0], h.device)
                  for p, h in zip(ps, hs)]
        train = True
    else:
        train = False
    pre = [_branches(p, h[:, 0] if decode else h, st["conv"], decode)
           for p, h, st in zip(ps, hs, states)]
    gates_in = all_gather([xr for _, xr, _ in pre], mesh, MODEL, -1)
    ys, new = [], []
    for p, (y, xr, tail), xg, st in zip(ps, pre, gates_in, states):
        h, h_t = _recur(p.rglru, xr, st["h"], chunk=chunk, decode=decode,
                        x_gate=xg)
        out = h.to(y.dtype) * y
        ys.append(linear_f32(out[:, None] if decode else out, p.w_o.weight))
        new.append({"conv": tail.float(), "h": h_t})
    return ys, (None if train else new)


def recurrent_step_stationary(ps, hs, states, *, policy):
    """``recurrent_block_step`` with the branch weights stationary
    (``Policy.decode_mode``): ``hs[r]`` (rows, 1, d/|data|) the rank's
    ``data`` slice of the normed residual; ``ps[r]`` rank r's shards, the
    gates ``w_a`` / ``w_i`` gathered over ``data`` (as the reference's
    decode program gathers them); ``states[r]`` its batch rows' conv tail
    and h on its d_rnn channels. The ``w_y`` / ``w_x`` partials are summed
    into the rank's batch rows of its channels (``psum_to_batch``), the
    conv and the RG-LRU run there (the gates read the conv output
    all-gathered over ``model``), and the gated output, gathered over the
    batch rows, meets the rank's ``w_o`` shard. Returns (the (B, 1,
    d/|data|) float32 partial sums, for the caller to reduce over
    ``model``; per-rank new states)."""
    mesh = policy.mesh
    parts = psum_to_batch([torch.cat([linear_f32(h, p.w_y.weight),
                                      linear_f32(h, p.w_x.weight)], -1)
                           for p, h in zip(ps, hs)], policy)
    pre = []
    for p, t, st in zip(ps, parts, states):
        y, xw = t[:, 0].to(hs[0].dtype).chunk(2, -1)
        pre.append((activation("gelu")(y),) + _conv_step(p, xw, st["conv"]))
    gates_in = all_gather([xr for _, xr, _ in pre], mesh, MODEL, -1)
    outs, new = [], []
    for p, (y, xr, tail), xg, st in zip(ps, pre, gates_in, states):
        h, _ = _recur(p.rglru, xr, st["h"], chunk=None, decode=True, x_gate=xg)
        outs.append((h.to(y.dtype) * y)[:, None])
        new.append({"conv": tail.float(), "h": h})
    return [linear_f32(o, p.w_o.weight)
            for p, o in zip(ps, gather_batch(outs, policy))], new


def griffin_state_shapes(batch, d_rnn):
    """``(shape, dtype)`` of each state tensor (both float32)."""
    return {"conv": ((batch, CONV_W - 1, d_rnn), torch.float32),
            "h": ((batch, d_rnn), torch.float32)}


def init_griffin_state(batch, d_rnn, device=None):
    """A zero state."""
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, (shape, dt) in griffin_state_shapes(batch, d_rnn).items()}
