"""Falsification-index scoring: matmul-form Eq. 4 (port of
``repro.kernels.indexed``).

``pos (m, n, 2o)`` is ``NA`` exactly where clause j excludes literal k, so
the membership mask ``pos != NA`` is the include mask and Eq. 4 becomes

    falsified(b, i, j)  =  Σ_k false_lit(b, k) · member(i, j, k)  >  0
    votes(b, i)         =  -Σ_j falsified(b, i, j) · pol(j)

Two bodies:

  * :func:`indexed_votes_ref` — plain PyTorch, the counterpart of the
    reference's ``indexed_votes_xla`` (a float32 product over 0/1 operands;
    hit counts ≤ 2o < 2²⁴ are exact). CPU tensors take it.
  * :func:`indexed_votes` — the hand-written CUDA kernel
    (``csrc/indexed_votes.cu``) that replaces the TPU kernel
    ``_indexed_votes_kernel`` (``src/repro/kernels/indexed.py:103``). It is
    bounded by reading ``pos`` and reads it once per 32 samples; see the
    source for the design.

Index maintenance, :func:`index_update_batched`, is PyTorch tensor code on
both devices: the reference has no Pallas body for it either (its registry
routes both backends to one XLA body), and the port has no kernel for it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

# Mirrors core.indexing.NA — the ClauseIndex layout's "excluded" sentinel.
NA = -1


def indexed_votes_ref(pos: torch.Tensor, lit: torch.Tensor,
                      pol: torch.Tensor) -> torch.Tensor:
    """(m, n, 2o) positions + (B, 2o) literals + (n,) ±1 polarity →
    (B, m) int32 vote sums ``-Σ_{j falsified} pol_j`` (plain PyTorch)."""
    m, n, L = pos.shape
    member = (pos != NA).reshape(m * n, L)
    false_lit = (lit == 0)
    hits = torch.matmul(false_lit.to(torch.float32),
                        member.to(torch.float32).T)          # (B, m·n)
    falsified = (hits > 0).reshape(-1, m, n)
    return -(falsified.to(torch.int32) * pol.to(torch.int32)).sum(
        -1, dtype=torch.int32)


@functools.cache
def _launcher():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.entry("indexed_votes", "indexed_votes_launch",
                        [p, p, p, p, p, i, i, i, i, i, p])


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"indexed_votes: {msg}")


def indexed_votes(pos: torch.Tensor, lit: torch.Tensor,
                  pol: torch.Tensor) -> torch.Tensor:
    """CUDA kernel: (B, m) int32 falsification votes, same contract as
    :func:`indexed_votes_ref`.

    Takes ``pos`` (m, n, 2o) int32, ``lit`` (B, 2o) uint8 and ``pol`` (n,)
    int32, all contiguous on one CUDA device, and raises on anything else.
    Launches on the current stream without synchronising.
    """
    _require(pos.is_cuda, f"pos must be a CUDA tensor, got {pos.device}")
    _require(lit.device == pos.device and pol.device == pos.device,
             f"operands on different devices: pos {pos.device}, "
             f"lit {lit.device}, pol {pol.device}")
    _require(pos.dtype == torch.int32 and pos.dim() == 3,
             f"pos must be (m, n, 2o) int32, got {tuple(pos.shape)} {pos.dtype}")
    m, n, L = pos.shape
    _require(lit.dtype == torch.uint8 and lit.dim() == 2 and lit.shape[1] == L,
             f"lit must be (B, {L}) uint8, got {tuple(lit.shape)} {lit.dtype}")
    _require(pol.dtype == torch.int32 and tuple(pol.shape) == (n,),
             f"pol must be ({n},) int32, got {tuple(pol.shape)} {pol.dtype}")
    _require(pos.is_contiguous() and lit.is_contiguous()
             and pol.is_contiguous(), "operands must be contiguous")
    b = lit.shape[0]
    out = torch.zeros((b, m), dtype=torch.int32, device=pos.device)
    if b == 0 or m == 0 or n == 0 or L == 0:
        return out
    fl = torch.empty(((b + 31) // 32, L), dtype=torch.int32, device=pos.device)
    vec4 = int(L % 4 == 0 and pos.data_ptr() % 16 == 0)
    launch = _launcher()
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = launch(pos.data_ptr(), lit.data_ptr(), pol.data_ptr(),
                      fl.data_ptr(), out.data_ptr(), m, n, L, b, vec4, stream)
    _build.check(code, "indexed_votes")
    indexed_votes.launches += 1
    return out


indexed_votes.launches = 0


def _segment_layout(keys: torch.Tensor):
    """Stable-sort layout of a key vector.

    Returns ``(order, start, last, first_idx)``: ``order`` is the stable
    sort permutation (equal keys keep buffer order), ``start`` / ``last``
    flag segment boundaries in sorted order, and ``first_idx[e]`` is the
    sorted position of e's segment head (a running maximum over the heads,
    the reference's ``associative_scan(maximum)``).
    """
    order = torch.argsort(keys, stable=True)
    sk = keys[order]
    one = torch.ones(1, dtype=torch.bool, device=keys.device)
    start = torch.cat([one, sk[1:] != sk[:-1]])
    last = torch.cat([sk[:-1] != sk[1:], one])
    idx = torch.arange(keys.shape[0], dtype=torch.int64, device=keys.device)
    first_idx = torch.cummax(torch.where(start, idx, 0), dim=0).values
    return order, start, last, first_idx


def _unsort(order: torch.Tensor, sorted_values: torch.Tensor) -> torch.Tensor:
    """Values in buffer order from values in ``order``'s sorted order (a
    permutation scatter: every cell written once)."""
    out = torch.empty_like(sorted_values)
    out[order] = sorted_values
    return out


def index_update_batched(lists: torch.Tensor, counts: torch.Tensor,
                         pos: torch.Tensor, cls: torch.Tensor,
                         clause: torch.Tensor, literal: torch.Tensor,
                         is_insert: torch.Tensor, valid: torch.Tensor):
    """Replay a masked event buffer into ``(lists, counts, pos)`` at once
    (port of the reference's ``index_update_batched``,
    ``src/repro/kernels/indexed.py:197``). Returns new tensors; the inputs
    are not modified.

    Precondition (the sequential ``apply_events`` contract): valid events
    are genuine include-boundary crossings in buffer order, so repeated
    events on one cell alternate. Then the result matches sequential replay
    in ``counts`` (exactly, overflow included), membership (``pos != NA``)
    and list contents as sets, with a consistent lists↔pos bijection; only
    the slot order inside a list may differ. It is the reference's algorithm
    step for step, so it equals the reference's output array for array:

      * net events per TA cell (an even run of alternating events cancels;
        an odd run's last event carries it), by a stable sort on the cell;
      * per-list delete and insert counts;
      * survivors of each touched list compacted in order, one
        representative event per list rewriting the row;
      * net inserts appended after the survivors in buffer order.

    The reference's ``mode="drop"`` scatters are explicit masks here, and
    every scatter writes each cell at most once (duplicate indices in a CUDA
    ``index_put_`` land in no fixed order): list rows once per
    representative, positions once per surviving or inserted clause.
    Capacity overflow drops the ids past ``capacity`` while ``counts`` keep
    the exact value, as in the reference.
    """
    m, L, cap = lists.shape
    n = pos.shape[1]
    E = cls.shape[0]
    if E == 0:
        return lists.clone(), counts.clone(), pos.clone()
    dev = lists.device
    idx = torch.arange(E, dtype=torch.int64, device=dev)
    v = valid.to(torch.bool)
    ins = is_insert.to(torch.bool)
    # invalid slots may hold any coordinates: read them at cell 0 (the
    # reference's gathers clamp), they are never written back
    c, j, k = (torch.where(v, t, 0).long() for t in (cls, clause, literal))

    # -- net events per TA cell: a run of alternating events on one cell is a
    # no-op when even; an odd run's last event carries its whole effect
    cell = torch.where(v, (c * n + j) * L + k, m * n * L)   # invalid → own tail
    order, _, last, first_idx = _segment_layout(cell)
    occ = idx - first_idx                                    # rank within run
    effective = _unsort(order, v[order] & last & (occ % 2 == 0))
    eff_ins = effective & ins
    eff_del = effective & ~ins

    # -- per-list aggregates (dense (m, 2o), exact integer sums)
    def per_list(mask):
        out = torch.zeros((m, L), dtype=torch.int32, device=dev)
        out.index_put_((c[mask], k[mask]),
                       torch.ones_like(c[mask], dtype=torch.int32),
                       accumulate=True)
        return out

    n_del, n_ins = per_list(eff_del), per_list(eff_ins)
    new_counts = counts + n_ins - n_del

    # -- membership: net deletes leave the index now; inserts land once
    # their append slots are known (one write per cell: net events are
    # unique per cell)
    pos2 = pos.clone()
    pos2[c[eff_del], j[eff_del], k[eff_del]] = NA

    # -- group effective events per inclusion list: the segment head is the
    # list's representative, and each net insert's rank among its list's
    # inserts fixes its append slot
    glist = torch.where(effective, c * L + k, m * L)
    order2, start2, _, first_idx2 = _segment_layout(glist)
    rep = _unsort(order2, start2 & effective[order2])
    ins_ind = eff_ins[order2].to(torch.int32)
    pre = torch.cumsum(ins_ind, dim=0, dtype=torch.int32) - ins_ind
    ins_rank = _unsort(order2, pre - pre[first_idx2])

    # -- compact the survivors of every touched list (a row per event; only
    # the representatives' rows are written back)
    rows = lists[c, k]                                       # (E, cap)
    old_cnt = counts[c, k]                                   # (E,)
    slot = torch.arange(cap, dtype=torch.int32, device=dev)[None, :]
    safe_ids = torch.where(rows >= 0, rows, 0).long()
    still = pos2[c[:, None], safe_ids, k[:, None]] != NA
    surv = (slot < old_cnt[:, None]) & (rows >= 0) & still   # (E, cap)
    new_slot = torch.cumsum(surv, dim=1, dtype=torch.int32) - 1
    new_rows = torch.full((E, cap), NA, dtype=torch.int32, device=dev)
    se, sc = torch.nonzero(surv, as_tuple=True)
    new_rows[se, new_slot[se, sc].long()] = rows[se, sc]

    # -- write back: representative rows, survivor positions, then the net
    # inserts' appends (past the capacity they are dropped from the lists,
    # never from pos)
    new_lists = lists.clone()
    new_lists[c[rep], k[rep]] = new_rows[rep]
    re, rc = torch.nonzero(surv & rep[:, None], as_tuple=True)
    pos2[c[re], safe_ids[re, rc], k[re]] = new_slot[re, rc]
    app_slot = old_cnt - n_del[c, k] + ins_rank              # survivors + rank
    fits = eff_ins & (app_slot < cap)
    new_lists[c[fits], k[fits], app_slot[fits].long()] = clause[fits].to(
        torch.int32)
    pos2[c[eff_ins], j[eff_ins], k[eff_ins]] = app_slot[eff_ins]
    return new_lists, new_counts, pos2
