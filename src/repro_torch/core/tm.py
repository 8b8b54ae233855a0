"""Tsetlin Machine forward pass (paper §2) — port of ``repro.core.tm``.

Only the forward (serving) half is ported in this slice:
``dense_clause_outputs``, ``clause_votes``, ``scores``, ``predict``,
``accuracy``. The learning round (Type I/II feedback, ``update_*``) comes
with training in the next slice.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import (
    TMConfig,
    TMState,
    clause_polarity,
    include_mask,
    literals_from_input,
)


def dense_clause_outputs(cfg: TMConfig, state: TMState, x: torch.Tensor, *,
                         empty_output: int | None = None) -> torch.Tensor:
    """Exhaustive clause evaluation. x: (B, o) {0,1} → (B, m, n) uint8.

    A clause is true iff no included literal is false:
      falsified(b, i, j) = ∃k: include[i,j,k] ∧ ¬literal[b,k].
    One float32 product counts the included-and-false literals per clause
    (0/1 operands, counts ≤ 2o < 2²⁴: exact whatever the matmul precision).
    """
    lit = literals_from_input(x)                          # (B, 2o)
    inc = include_mask(cfg, state)                        # (m, n, 2o)
    m, n, L = inc.shape
    false_lit = (1 - lit).to(torch.float32)
    counts = torch.matmul(false_lit, inc.reshape(m * n, L).to(torch.float32).T)
    out = (counts < 0.5).to(torch.uint8).reshape(-1, m, n)
    empty_output = cfg.empty_clause_output if empty_output is None else empty_output
    if empty_output == 0:
        empty = ~inc.any(dim=-1)                          # (m, n)
        out = out * (~empty).to(torch.uint8)[None]
    return out


def clause_votes(cfg: TMConfig, clause_out: torch.Tensor) -> torch.Tensor:
    """(B, m, n) clause outputs → (B, m) int32 polarity-signed vote sums."""
    pol = clause_polarity(cfg, clause_out.device)
    return (clause_out.to(torch.int32) * pol).sum(-1, dtype=torch.int32)


def scores(cfg: TMConfig, state: TMState, x: torch.Tensor) -> torch.Tensor:
    """(B, m) class scores via the dense path."""
    return clause_votes(cfg, dense_clause_outputs(cfg, state, x))


def predict(cfg: TMConfig, state: TMState, x: torch.Tensor) -> torch.Tensor:
    """(B,) argmax class (Eq. 3); ties go to the lowest class, as in JAX."""
    return torch.argmax(scores(cfg, state, x), dim=-1)


def accuracy(cfg: TMConfig, state: TMState, xs: torch.Tensor,
             ys: torch.Tensor) -> torch.Tensor:
    """Fraction of ``xs`` rows whose argmax vote equals ``ys``."""
    return (predict(cfg, state, xs) == ys).to(torch.float32).mean()
