"""Clause indexing (paper §3) — port of ``repro.core.indexing``.

``ClauseIndex`` holds the paper's inclusion lists ``L[i,k]`` (capacity-bound
rows of clause ids), their counts ``n[i,k]`` and the position matrix
``M[i,j,k]``. Scoring reads only ``pos != NA`` (the matmul form of Eq. 4,
``kernels/indexed.py``).

Maintenance: training updates the TA states densely, then
:func:`events_from_transition` diffs the include masks into a fixed-size,
counted ``EventBuffer`` and :func:`index_update` replays it in one batched
pass (the ``index_update`` primitive). :func:`insert` / :func:`delete` are
the paper's O(1) swap-with-last updates, and :func:`apply_events` replays a
buffer through them one event at a time: the sequential oracle the batched
replay is tested against.

The reference's ``mode="drop"`` scatters become explicit masks here: an
entry whose slot lies past the capacity is not written, exactly as JAX
drops it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.types import TMConfig, TMState, include_mask
from repro_torch.kernels import backend as kbackend

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


def shard_capacity(capacity: int, n_shards: int) -> int:
    """Per-shard list capacity of a clause-sharded index: ⌈capacity/S⌉.

    A shard's worst case is its clause count, ⌈n_clauses/S⌉ under the ragged
    clause geometry, and the default capacity is ``n_clauses``, so the
    ceiling covers every shard for any shard count. A shard's lists hold
    its own local clause ids, which stay dense under clause-axis padding:
    a padding row includes no literal and never enters a list.
    """
    return -(-capacity // n_shards)


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


# ---------------------------------------------------------------------------
# Maintenance (paper §3 "Index Construction and Maintenance")
# ---------------------------------------------------------------------------


class Event(NamedTuple):
    """TA include/exclude boundary crossings (a buffer: every field (E,))."""

    cls: torch.Tensor        # int32
    clause: torch.Tensor     # int32
    literal: torch.Tensor    # int32
    is_insert: torch.Tensor  # bool — exclude → include
    valid: torch.Tensor      # bool — masking for fixed-size buffers


class EventBuffer(NamedTuple):
    """A fixed-capacity masked event buffer and its overflow counter.

    ``overflow`` counts the boundary crossings that did not fit. Dropped
    events leave every derived cache stale, so a non-zero count is a config
    error (``max_events`` too small for the batch); ``TMBundle.
    event_overflow`` accumulates it across steps.
    """

    events: Event
    overflow: torch.Tensor   # () int32


def _insert_(lists, counts, pos, i: int, j: int, k: int) -> None:
    c = int(counts[i, k])
    if c < lists.shape[-1]:          # past the capacity the id is dropped
        lists[i, k, c] = j
    pos[i, j, k] = c
    counts[i, k] += 1


def _delete_(lists, counts, pos, i: int, j: int, k: int) -> None:
    p = int(pos[i, j, k])
    last = int(counts[i, k]) - 1
    moved = int(lists[i, k, last])
    lists[i, k, p] = moved
    pos[i, moved, k] = p
    lists[i, k, last] = NA
    counts[i, k] -= 1
    pos[i, j, k] = NA


def _copy(index: ClauseIndex) -> ClauseIndex:
    return ClauseIndex(*(t.clone() for t in index))


def insert(index: ClauseIndex, i: int, j: int, k: int) -> ClauseIndex:
    """TA (i, j, k) flipped exclude → include: append j to list (i, k).

        n_k^i ← n_k^i + 1,   L_k^i[n] ← j,   M_k^{ij} ← n

    (0-based; the paper writes 1-based.) Returns a new index."""
    out = _copy(index)
    _insert_(*out, int(i), int(j), int(k))
    return out


def delete(index: ClauseIndex, i: int, j: int, k: int) -> ClauseIndex:
    """TA (i, j, k) flipped include → exclude: swap-with-last removal.

        p ← M_k^{ij},  L_k^i[p] ← L_k^i[n-1],  M_k^{i,moved} ← p,
        n_k^i ← n_k^i - 1,  M_k^{ij} ← NA

    The list must hold j within its capacity. Returns a new index."""
    out = _copy(index)
    _delete_(*out, int(i), int(j), int(k))
    return out


def apply_events(index: ClauseIndex, events: Event) -> ClauseIndex:
    """Replay a masked event buffer one event at a time (the sequential
    oracle, for tests): valid events only, in buffer order, each the paper's
    O(1) pointer algebra, on host copies. Lists must stay within their
    capacity."""
    host = [t.cpu().numpy().copy() for t in index]
    for i, j, k, ins, ok in zip(*(t.tolist() for t in events)):
        if ok:
            (_insert_ if ins else _delete_)(*host, i, j, k)
    dev = index.lists.device
    return ClauseIndex(*(torch.from_numpy(a).to(dev) for a in host))


def index_update(index: ClauseIndex, events: Event) -> ClauseIndex:
    """Batched event replay, the production form of :func:`apply_events`,
    through the ``index_update`` primitive (``kernels/indexed.py``): the
    same membership, counts and lists↔pos bijection as sequential replay,
    with only the slot order inside a list free. Returns a new index."""
    lists, counts, pos = kbackend.resolve("index_update")(
        index.lists, index.counts, index.pos, *events)
    return ClauseIndex(lists=lists, counts=counts, pos=pos)


def events_from_transition(old_include: torch.Tensor,
                           new_include: torch.Tensor,
                           max_events: int) -> EventBuffer:
    """Diff two (m, n, 2o) include masks into a counted event buffer.

    The first ``max_events`` changed cells in ascending cell order fill the
    buffer, then (masked out) the first unchanged cells, also ascending:
    the reference's two-cumsum selection, slot for slot. The cumsums run in
    int32 (over 31.4 M cells at ``tm_mnist`` the int64 default would double
    the temporaries). Changed cells past the buffer are counted in
    ``overflow``.
    """
    changed = old_include != new_include
    flat = changed.reshape(-1)
    m, n, L = old_include.shape
    cells = flat.shape[0]
    dev = flat.device
    max_events = min(max_events, cells)
    total = flat.sum(dtype=torch.int32)
    ranks = torch.cumsum(flat, 0, dtype=torch.int32) - 1          # changed
    pad_ranks = total + torch.cumsum(~flat, 0, dtype=torch.int32) - 1
    slot = torch.where(flat, ranks, pad_ranks)          # a bijection on cells
    del ranks, pad_ranks
    keep = torch.nonzero(slot < max_events).squeeze(1)  # one cell per slot
    sel = torch.zeros((max_events,), dtype=torch.int64, device=dev)
    sel[slot[keep].long()] = keep
    cls, rem = sel // (n * L), sel % (n * L)
    return EventBuffer(
        events=Event(cls=cls.to(torch.int32),
                     clause=(rem // L).to(torch.int32),
                     literal=(rem % L).to(torch.int32),
                     is_insert=new_include.reshape(-1)[sel],
                     valid=flat[sel]),
        overflow=(total - max_events).clamp(min=0).to(torch.int32))
