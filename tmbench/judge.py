"""Reading the program's outputs to judge them against the reference.

The inclusion lists are compared as sets: each list's used prefix
``min(count, capacity)`` is turned into a multiplicity per (class,
literal, clause), with one extra column counting entries that are no
clause id; the reference's membership is its include mask.
"""
from __future__ import annotations

import torch


def list_multiplicity(lists: torch.Tensor, counts: torch.Tensor,
                      n: int) -> torch.Tensor:
    """(m, 2o, cap) lists + (m, 2o) counts → (m, 2o, n + 1) int8: how often
    each clause id appears in each list's used prefix (saturating at 127);
    column n counts entries that are no id in ``[0, n)``."""
    m, two_o, cap = lists.shape
    used = (torch.arange(cap, device=lists.device)
            < counts.clamp(min=0, max=cap)[..., None])
    ok = (lists >= 0) & (lists < n)
    idx = torch.where(ok, lists, n).long()
    mult = torch.zeros((m, two_o, n + 1), dtype=torch.int32, device=lists.device)
    mult.scatter_add_(2, idx, used.to(torch.int32))
    return mult.clamp_(max=127).to(torch.int8)


def lists_wrong(mult: torch.Tensor, include: torch.Tensor) -> int:
    """Cells where the lists as sets differ from ``include`` (m, n, 2o),
    plus every entry that is no clause id."""
    n = include.shape[1]
    member = include.transpose(1, 2).to(torch.int8)
    mult = mult.to(include.device)
    return int((mult[..., :n] != member).sum()) + int(mult[..., n].to(torch.int64).sum())


def counts_wrong(counts: torch.Tensor, include: torch.Tensor) -> int:
    """Lists whose count differs from the include mask's list length."""
    want = include.sum(1, dtype=torch.int32)
    return int((counts.to(include.device) != want).sum())
