"""Clause indexing (paper §3) — construction half, port of
``repro.core.indexing``.

``ClauseIndex`` holds the paper's inclusion lists ``L[i,k]`` (capacity-bound
rows of clause ids), their counts ``n[i,k]`` and the position matrix
``M[i,j,k]``. Scoring reads only ``pos != NA`` (the matmul form of Eq. 4,
``kernels/indexed.py``). Incremental maintenance (``insert``/``delete``,
``index_update``, the event buffer) comes with training in the next slice.

The reference's ``mode="drop"`` scatters become explicit masks here: an
entry whose slot lies past the capacity is not written, exactly as JAX
drops it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.types import TMConfig, TMState, include_mask

NA = -1


class ClauseIndex(NamedTuple):
    """The falsification index (all int32)."""

    lists: torch.Tensor   # (m, 2o, cap) clause ids; NA beyond counts
    counts: torch.Tensor  # (m, 2o)
    pos: torch.Tensor     # (m, n, 2o) position of clause j in list k; NA if absent

    @property
    def capacity(self) -> int:
        """List capacity (rows per inclusion list)."""
        return self.lists.shape[-1]


def empty_index(cfg: TMConfig, capacity: int, device) -> ClauseIndex:
    """All TAs exclude ⇒ all lists empty."""
    m, n, L = cfg.n_classes, cfg.n_clauses, cfg.n_literals
    return ClauseIndex(
        lists=torch.full((m, L, capacity), NA, dtype=torch.int32, device=device),
        counts=torch.zeros((m, L), dtype=torch.int32, device=device),
        pos=torch.full((m, n, L), NA, dtype=torch.int32, device=device),
    )


def build_index(cfg: TMConfig, state: TMState, capacity: int) -> ClauseIndex:
    """Vectorised full (re)build from the include mask.

    Clause ids are placed in ascending order per list; ``pos`` keeps every
    included clause's slot even past ``capacity`` (as the reference does),
    while ``lists`` drops those entries.
    """
    inc_t = include_mask(cfg, state).transpose(1, 2)             # (m, 2o, n)
    counts = inc_t.sum(-1, dtype=torch.int32)                    # (m, 2o)
    slot = torch.cumsum(inc_t.to(torch.int32), dim=-1, dtype=torch.int32) - 1
    slot = torch.where(inc_t, slot, NA)
    m, L, _ = inc_t.shape
    lists = torch.full((m, L, capacity), NA, dtype=torch.int32,
                       device=inc_t.device)
    ii, kk, jj = torch.nonzero(inc_t & (slot < capacity), as_tuple=True)
    lists[ii, kk, slot[ii, kk, jj]] = jj.to(torch.int32)
    pos = slot.transpose(1, 2).contiguous()                      # (m, n, 2o)
    return ClauseIndex(lists=lists, counts=counts, pos=pos)


def validate(cfg: TMConfig, state: TMState, index: ClauseIndex) -> dict:
    """Invariant checks: ``{name: 0-d bool tensor}``."""
    inc = include_mask(cfg, state)
    rebuilt_counts = inc.transpose(1, 2).sum(-1, dtype=torch.int32)
    counts_ok = torch.all(index.counts == rebuilt_counts)
    overflow_ok = torch.all(index.counts <= index.capacity)
    # membership: pos[i,j,k] != NA  ⇔  include[i,j,k]
    member = index.pos != NA
    member_ok = torch.all(member == inc)
    # round-trip: lists[i, k, pos[i,j,k]] == j wherever included
    m, n, L = index.pos.shape
    dev = index.pos.device
    ii = torch.arange(m, device=dev)[:, None, None]
    kk = torch.arange(L, device=dev)[None, None, :]
    # slots past the capacity read slot cap-1, like JAX's clamped gather
    safe_pos = torch.where(member, index.pos, 0).clamp(max=index.capacity - 1)
    back = index.lists[ii, kk, safe_pos]                          # (m, n, 2o)
    jj = torch.arange(n, dtype=torch.int32, device=dev)[None, :, None]
    roundtrip_ok = torch.all(torch.where(member, back == jj, True))
    return dict(counts_ok=counts_ok, overflow_ok=overflow_ok,
                member_ok=member_ok, roundtrip_ok=roundtrip_ok)
