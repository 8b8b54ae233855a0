"""Clause indexing (paper §3) — port of ``repro.core.indexing``.

``ClauseIndex`` holds the paper's inclusion lists ``L[i,k]`` (capacity-bound
rows of clause ids), their counts ``n[i,k]`` and the position matrix
``M[i,j,k]``. Scoring walks the false literals' lists (Eq. 4,
``kernels/indexed.py``), and reads a column of ``pos`` only for a list
that overflowed its capacity.

Maintenance: training updates the TA states densely, then
:func:`events_from_transition` diffs the include masks into a fixed-size,
counted ``EventBuffer`` and :func:`index_update` replays it in one batched
pass (the ``index_update`` primitive). :func:`insert` / :func:`delete` are
the paper's O(1) swap-with-last updates, and :func:`apply_events` replays a
buffer through them one event at a time: the sequential oracle the batched
replay is tested against.

Index-based inference: :func:`indexed_partial_scores` /
:func:`indexed_scores` go through the ``indexed_votes`` primitive, and
:func:`indexed_work` / :func:`dense_work` are the paper's work metric
(§3 "Remarks": about 0.02 on MNIST, 0.006 on IMDb).

The clause-compact (transpose) layout ``CompactClauses`` holds each
clause's included literal ids (:func:`compact`, :func:`compact_eval`,
:func:`compact_scores`, :func:`validate_compact`); training keeps it in
step through :func:`compact_apply_events`, a replay vectorised over the
event buffer, with :func:`compact_apply_events_sequential` (the
reference's one-event-at-a-time scan, on the host) as its test oracle.

The reference's ``mode="drop"`` scatters become explicit masks here: an
entry whose slot lies past the capacity is not written, exactly as JAX
drops it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import tm
from repro_torch.core.types import (
    TMConfig, TMState, clause_polarity, include_mask, literals_from_input)
from repro_torch.kernels import backend as kbackend
from repro_torch.kernels.indexed import _segment_layout, _unsort

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


# ---------------------------------------------------------------------------
# Index-based inference (paper §3 "Index Based Inference", Eq. 4)
# ---------------------------------------------------------------------------


def indexed_partial_scores(index: ClauseIndex, x: torch.Tensor,
                           pol: torch.Tensor) -> torch.Tensor:
    """(B, o) inputs + per-clause ±1 polarity → (B, m) int32 partial vote
    sums ``-Σ_{j falsified} pol_j`` over the clauses this index covers,
    through the ``indexed_votes`` primitive: a walk of the false literals'
    inclusion lists (the CUDA kernel on the card).
    The partials of a clause-sharded index's shards add up to the scores."""
    return kbackend.resolve("indexed_votes")(
        index.lists, index.counts, index.pos, literals_from_input(x), pol)


def indexed_scores(cfg: TMConfig, index: ClauseIndex,
                   x: torch.Tensor) -> torch.Tensor:
    """(B, o) inputs → (B, m) scores by falsification look-up (Eq. 4):
    equal to the dense scores with ``empty_clause_output=1``."""
    return indexed_partial_scores(index, x,
                                  clause_polarity(cfg, index.pos.device))


def indexed_work(index: ClauseIndex, x: torch.Tensor) -> torch.Tensor:
    """The paper's work metric per sample, ``Σ_i Σ_{k false} |L[i,k]|``
    (B,) int32: the list entries a falsification look-up visits. Over
    :func:`dense_work` it gives the §3 work ratio."""
    false_lit = literals_from_input(x) == 0                      # (B, 2o)
    per_literal = index.counts.sum(0, dtype=torch.int64)         # (2o,)
    return (false_lit * per_literal).sum(-1).to(torch.int32)


def dense_work(cfg: TMConfig) -> int:
    """Work of exhaustive evaluation: m·n·2o literal inspections."""
    return cfg.n_classes * cfg.n_clauses * cfg.n_literals


# ---------------------------------------------------------------------------
# Clause-compact (transpose) layout
# ---------------------------------------------------------------------------


class CompactClauses(NamedTuple):
    """Each clause's included literal ids (all int32)."""

    lit_idx: torch.Tensor  # (m, n, l_max) literal ids; NA beyond lengths
    lengths: torch.Tensor  # (m, n)


def compact(cfg: TMConfig, state: TMState, l_max: int) -> CompactClauses:
    """Include mask → per-clause rows of included literal ids, ascending.

    ``lengths`` are the true clause lengths, also past ``l_max`` (then
    :func:`validate_compact` reports ``overflow_ok`` False), and the ids
    past ``l_max`` are dropped, as the reference drops them.
    """
    inc = include_mask(cfg, state)                                # (m, n, 2o)
    m, n, _ = inc.shape
    lengths = inc.sum(-1, dtype=torch.int32)
    slot = torch.cumsum(inc.to(torch.int32), dim=-1, dtype=torch.int32) - 1
    lit_idx = torch.full((m, n, l_max), NA, dtype=torch.int32,
                         device=inc.device)
    ii, jj, kk = torch.nonzero(inc & (slot < l_max), as_tuple=True)
    lit_idx[ii, jj, slot[ii, jj, kk].long()] = kk.to(torch.int32)
    return CompactClauses(lit_idx=lit_idx, lengths=lengths)


def compact_eval(cfg: TMConfig, comp: CompactClauses,
                 x: torch.Tensor) -> torch.Tensor:
    """(B, o) → (B, m, n) uint8 clause outputs from the included literals
    alone: a clause is false iff one of its literals is false. Empty
    clauses evaluate true (Eq. 4).

    Work: B·m·n·l_max gathered booleans (an extra never-false column
    stands for the ``NA`` slots), against B·m·n·2o for the dense form.
    """
    del cfg
    lit = literals_from_input(x)                                  # (B, 2o)
    b, n_lit = lit.shape
    false_lit = torch.cat(
        [lit == 0, torch.zeros((b, 1), dtype=torch.bool, device=lit.device)],
        dim=1)
    idx = torch.where(comp.lit_idx == NA, n_lit, comp.lit_idx)    # (m, n, l_max)
    falsified = false_lit.index_select(1, idx.reshape(-1)).reshape(
        b, *idx.shape).any(-1)
    return (~falsified).to(torch.uint8)


def compact_scores(cfg: TMConfig, comp: CompactClauses,
                   x: torch.Tensor) -> torch.Tensor:
    """(B, o) → (B, m) int32 class scores through :func:`compact_eval`."""
    return tm.clause_votes(cfg, compact_eval(cfg, comp, x))


def compact_apply_events_sequential(comp: CompactClauses,
                                    events: Event) -> CompactClauses:
    """Replay an event buffer one event at a time, on host copies: the
    reference's ``lax.scan`` step for step (the test oracle of
    :func:`compact_apply_events`). An insert appends the literal (dropped,
    length unchanged, past ``l_max``); a delete swaps the last entry into
    the literal's slot, and is a no-op for a literal the row does not hold.
    """
    lit_idx, lengths = (t.cpu().numpy().copy() for t in comp)
    l_max = lit_idx.shape[-1]
    for i, j, k, ins, ok in zip(*(t.tolist() for t in events)):
        if not ok:
            continue
        row = lit_idx[i, j]
        if ins:
            if lengths[i, j] < l_max:
                row[lengths[i, j]] = k
                lengths[i, j] += 1
            continue
        hits = (row == k).nonzero()[0]
        if hits.size:
            last = lengths[i, j] - 1
            row[hits[0]] = row[last]
            row[last] = NA
            lengths[i, j] -= 1
    dev = comp.lit_idx.device
    return CompactClauses(lit_idx=torch.from_numpy(lit_idx).to(dev),
                          lengths=torch.from_numpy(lengths).to(dev))


# literal ids are < 2**31, so (row, literal) packs into one int64 key
_LITERAL_SPAN = 1 << 31


def compact_apply_events(comp: CompactClauses, events: Event) -> CompactClauses:
    """Replay include/exclude events on the clause-compact layout at once,
    vectorised over the event buffer. Returns new tensors.

    Contract, against the reference's sequential scan
    (:func:`compact_apply_events_sequential`), for a buffer diffed against
    exactly the state this cache was built from (so each valid event names
    a distinct TA cell, as ``events_from_transition``'s buffers do):

      * whenever no row's length passes ``l_max``, ``lengths`` are
        identical and every row holds the identical set of literal ids;
        only the order inside a row may differ (rows are sets:
        ``compact_eval`` is order-blind);
      * at overflow, ``lengths`` and the sets are still the reference's:
        an insert is dropped exactly when the reference's running length
        stood at ``l_max`` when it came, and a delete of a literal the row
        never absorbed is a no-op. So ``lengths <= l_max``, no surviving
        entry is corrupted, slots past a length stay ``NA``, and
        :func:`validate_compact` reports ``lengths_ok=False`` wherever the
        reference's does.

    A buffer that names one cell several times (alternating crossings, as
    ``index_update_batched`` admits) is first reduced to its net event per
    cell; without overflow the result is again the reference's, and at
    overflow the invariants above hold.

    How: net events per cell; the survivors of each touched row (entries no
    net delete names) compacted in order; each row's running length in
    buffer order as a walk clamped at ``l_max`` (an insert that finds the
    row full is dropped, a delete that finds its literal lowers it), whose
    accepted inserts are appended after the survivors.
    """
    lit_idx, lengths = comp
    m, n, l_max = lit_idx.shape
    n_events = events.cls.shape[0]
    if n_events == 0:
        return CompactClauses(lit_idx.clone(), lengths.clone())
    dev = lit_idx.device
    v = events.valid.to(torch.bool)
    ins = events.is_insert.to(torch.bool)
    c, j, k = (torch.where(v, t, 0).long()
               for t in (events.cls, events.clause, events.literal))
    idx = torch.arange(n_events, dtype=torch.int64, device=dev)

    # -- net event per cell: an odd run's last event carries its effect
    row_key = c * n + j
    cell = torch.where(v, row_key * _LITERAL_SPAN + k, m * n * _LITERAL_SPAN)
    order, _, last, first_idx = _segment_layout(cell)
    effective = _unsort(order, v[order] & last & ((idx - first_idx) % 2 == 0))

    # -- group the net events by clause row, buffer order within a row
    order, start, _, first_idx = _segment_layout(
        torch.where(effective, row_key, m * n))
    eff, ins, k, key = effective[order], ins[order], k[order], row_key[order]
    head = start & eff
    rid = torch.cumsum(head, 0) - 1                # touched-row id per event
    heads = torch.nonzero(head).squeeze(1)
    if heads.numel() == 0:
        return CompactClauses(lit_idx.clone(), lengths.clone())
    rc, rj = c[order][heads], j[order][heads]
    rows = lit_idx[rc, rj]                                       # (R, l_max)
    old_len = lengths[rc, rj].long()
    rid = rid.clamp(min=0)

    # -- entries a net delete names, matched through sorted (row, literal)
    # keys; each match also marks its delete as present in the row
    slot = torch.arange(l_max, device=dev)[None, :]
    live = (slot < old_len[:, None]) & (rows >= 0)
    is_del = eff & ~ins
    del_at = torch.nonzero(is_del).squeeze(1)
    del_keys, del_order = torch.sort(key[del_at] * _LITERAL_SPAN + k[del_at])
    present = torch.zeros(n_events, dtype=torch.bool, device=dev)
    hit = torch.zeros_like(live)
    if del_keys.numel():
        entry_keys = key[heads][:, None] * _LITERAL_SPAN + rows.long()
        at = torch.searchsorted(del_keys, entry_keys).clamp(
            max=del_keys.numel() - 1)
        hit = live & (del_keys[at] == entry_keys)
        found = torch.zeros(del_keys.numel(), dtype=torch.bool, device=dev)
        found[at[hit]] = True
        present[del_at[del_order]] = found

    # -- each row's running length in buffer order, clamped at l_max: the
    # unclamped walk minus the running maximum of its excess over l_max
    step = torch.where(eff & ins, 1, torch.where(present, -1, 0))
    walk = torch.cumsum(step, 0)
    walk = old_len[rid] + walk - (walk[first_idx] - step[first_idx])
    span = 2 * n_events + l_max + 1       # > any row's range of excess
    excess = torch.where(eff, walk - l_max + rid * span,
                         heads.numel() * span)
    clamp = (torch.cummax(excess, 0).values - rid * span).clamp(min=0)
    before = torch.where(start, 0, torch.roll(clamp, 1))
    accepted = eff & ins & (clamp == before)

    # -- new rows: survivors compacted, then accepted inserts appended
    survive = live & ~hit
    n_surv = survive.sum(1)
    new_rows = torch.full_like(rows, NA)
    sr, ss = torch.nonzero(survive, as_tuple=True)
    new_rows[sr, (torch.cumsum(survive, 1) - 1)[sr, ss]] = rows[sr, ss]
    acc = accepted.long()
    rank = torch.cumsum(acc, 0) - acc
    rank = rank - rank[first_idx]
    new_rows[rid[accepted], (n_surv[rid] + rank)[accepted]] = (
        k[accepted].to(torch.int32))
    n_acc = torch.zeros_like(n_surv).index_add_(0, rid[accepted],
                                                acc[accepted])
    out_idx, out_len = lit_idx.clone(), lengths.clone()
    out_idx[rc, rj] = new_rows
    out_len[rc, rj] = (n_surv + n_acc).to(torch.int32)
    return CompactClauses(lit_idx=out_idx, lengths=out_len)


def validate_compact(cfg: TMConfig, state: TMState,
                     comp: CompactClauses) -> dict:
    """Invariant checks for the clause-compact layout: ``{name: 0-d bool
    tensor}``. ``lengths_ok`` fails when capacity overflow has lost
    literals: ``lengths`` track true clause lengths only while they fit."""
    inc = include_mask(cfg, state)                                # (m, n, 2o)
    l_max = comp.lit_idx.shape[-1]
    lengths_ok = torch.all(comp.lengths == inc.sum(-1, dtype=torch.int32))
    overflow_ok = torch.all(comp.lengths <= l_max)
    na = comp.lit_idx == NA
    # every non-NA entry is an included literal of its clause (ids out of
    # range read the last literal, like JAX's clamped gather)
    safe = torch.where(na, 0, comp.lit_idx).long().clamp(
        max=inc.shape[-1] - 1)
    member_ok = torch.all(torch.gather(inc, 2, safe) | na)
    slot_valid = (torch.arange(l_max, device=inc.device)[None, None, :]
                  < comp.lengths[..., None])
    padding_ok = torch.all(slot_valid | na)
    return dict(lengths_ok=lengths_ok, overflow_ok=overflow_ok,
                member_ok=member_ok, padding_ok=padding_ok)
