"""Unpacked oracles for the TM kernels — port of ``repro.kernels.ref``
(plain PyTorch; no bit packing, no bit tricks).

Not to be confused with the ``*_ref`` plain bodies beside each kernel
(``kernels/clause_eval.py``, ``kernels/ta_update.py``): those take the
kernels' own operands — packed include and literal words — and are the
bodies a CPU tensor runs. These take the **unpacked** ``(m, n, 2o)`` include
mask and ``(B, 2o)`` literals, so holding a wrapper of ``kernels/ops.py``
against them checks ``pack_bits`` and the kernel together.

Clause outputs come from an int32 count of the included-and-false literals
per clause, none meaning true, as the reference's float32 count ``< 0.5``
decides: exact on every device, with no matmul precision to pin. The count
goes through a ``(B, m, n, 2o)`` boolean temporary (about 1 GB at the
tm_mnist width with B = 32): an oracle's cost, not a kernel's.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ta_update import thresholds


def _false_counts(include: torch.Tensor, lit: torch.Tensor) -> torch.Tensor:
    """(m, n, 2o) include + (B, 2o) literals → (B, m, n) int32 counts of
    included literals that are false."""
    false_lit = (lit == 0)[:, None, None, :]
    return (include.to(torch.bool)[None] & false_lit).sum(-1, dtype=torch.int32)


def clause_votes_ref(include: torch.Tensor, lit: torch.Tensor) -> torch.Tensor:
    """(m, n, 2o) bool include + (B, 2o) {0,1} literals → (B, m) int32
    polarity-signed votes (first half of the clauses positive); an empty
    clause counts as true."""
    n = include.shape[1]
    out = (_false_counts(include, lit) == 0).to(torch.int32)    # (B, m, n)
    sign = torch.where(torch.arange(n, device=include.device) < n // 2, 1, -1)
    return (out * sign.to(torch.int32)).sum(-1, dtype=torch.int32)


def clause_outputs_ref(include: torch.Tensor, lit: torch.Tensor) -> torch.Tensor:
    """(B, m, n) int8 clause outputs; an empty clause gives 1."""
    return (_false_counts(include, lit) == 0).to(torch.int8)


def ta_update_ref(ta_row: torch.Tensor, lit: torch.Tensor,
                  clause_out: torch.Tensor, gets_type_i: torch.Tensor,
                  active: torch.Tensor, uniforms: torch.Tensor, *,
                  n_states: int, s: float,
                  boost_true_positive: bool = False) -> torch.Tensor:
    """(n, 2o) int16 states + (2o,) literals + (n,) clause outputs, Type I
    routing and update gates + (n, 2o) float32 uniforms → (n, 2o) int16.

    Written as the reference writes it, apart from the plain body that a
    CPU tensor runs (``kernels/ta_update.ta_update_ref``), so a wrapper on
    the CPU is not held against its own body.

    The thresholds are ``kernels/ta_update.thresholds``: the double ``1/s``
    and ``1 - 1/s`` rounded once to float32, the values the reference's
    float32 uniforms are compared with, so the oracle agrees with the kernel
    on draws at a threshold's edge too.
    """
    inv_s, p_reward = thresholds(s, boost_true_positive)
    include = ta_row > n_states
    c1 = (clause_out == 1)[:, None]
    l1 = (lit == 1)[None, :]
    reward = c1 & l1 & (uniforms < p_reward)
    penalty = ((c1 & ~l1) | ~c1) & (uniforms < inv_s)
    d1 = reward.to(torch.int16) - penalty.to(torch.int16)
    d2 = (c1 & ~l1 & ~include).to(torch.int16)
    act = active.to(torch.bool)[:, None]
    t1 = gets_type_i.to(torch.bool)[:, None]
    zero = torch.zeros((), dtype=torch.int16, device=ta_row.device)
    delta = torch.where(act & t1, d1, torch.where(act & ~t1, d2, zero))
    return torch.clamp(ta_row.to(torch.int16) + delta, 1,
                       2 * n_states).to(torch.int16)
