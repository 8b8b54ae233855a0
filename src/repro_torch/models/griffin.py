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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import activation, empty_linear, init_linear_
from repro_torch.models.recurrence import chunked_diag_recurrence

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


def _rglru_coeffs(p: RGLRU, x):
    """x: (…, d_rnn) → (a, b) of the diagonal recurrence, float32.

    softplus(Λ) is taken in Λ's dtype (bf16 under bf16 serving), as the
    reference's is; sqrt(1 - a²) goes through expm1 for a near 1."""
    xf = x.float()
    r = torch.sigmoid(F.linear(xf, p.w_a.weight.float()) + p.b_a.float())
    i = torch.sigmoid(F.linear(xf, p.w_i.weight.float()) + p.b_i.float())
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


def recurrent_block_seq(p: RecurrentBlock, x, state, *, chunk):
    """x: (B, T, d); state: {"conv": (B, 3, dr), "h": (B, dr)}."""
    gelu = activation("gelu")
    y = gelu(_lin(p.w_y, x))
    xr, conv_tail = _causal_conv_seq(p, _lin(p.w_x, x), state["conv"])
    a, b = _rglru_coeffs(p.rglru, xr)
    hs, h_t = chunked_diag_recurrence(a.transpose(0, 1), b.transpose(0, 1),
                                      state["h"].float(), chunk=chunk)
    h = hs.transpose(0, 1).to(x.dtype)                    # (B, T, dr)
    return _lin(p.w_o, h * y), {"conv": conv_tail.float(), "h": h_t}


def recurrent_block_step(p: RecurrentBlock, x, state):
    """x: (B, d), a single token."""
    gelu = activation("gelu")
    y = gelu(_lin(p.w_y, x))
    hist = torch.cat([state["conv"].to(x.dtype), _lin(p.w_x, x)[:, None]], 1)
    conv = sum(hist[:, -1 - i] * p.conv_w[CONV_W - 1 - i].to(x.dtype)
               for i in range(CONV_W)) + p.conv_b.to(x.dtype)
    a, b = _rglru_coeffs(p.rglru, conv)
    h = a * state["h"].float() + b
    return (_lin(p.w_o, h.to(x.dtype) * y),
            {"conv": hist[:, 1:].float(), "h": h})


def griffin_state_shapes(batch, d_rnn):
    """``(shape, dtype)`` of each state tensor (both float32)."""
    return {"conv": ((batch, CONV_W - 1, d_rnn), torch.float32),
            "h": ((batch, d_rnn), torch.float32)}


def init_griffin_state(batch, d_rnn, device=None):
    """A zero state."""
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, (shape, dt) in griffin_state_shapes(batch, d_rnn).items()}
