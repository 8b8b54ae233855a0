"""Falsification-index scoring (port of ``repro.kernels.indexed``).

Eq. 4 of the paper: a clause is falsified by a sample when one of its
included literals is false there, and

    votes(b, i)  =  -Σ_j falsified(b, i, j) · pol(j)

Three bodies compute it:

  * :func:`indexed_votes_ref` — the matmul form over the position matrix
    ``pos (m, n, 2o)``, which is ``NA`` exactly where clause j excludes
    literal k, so ``pos != NA`` is the include mask: a float32 product of
    the false literals with that mask (hit counts ≤ 2o < 2²⁴ are exact).
    It is the counterpart of the reference's ``indexed_votes_xla`` and the
    oracle the tests hold against the JAX package.
  * :func:`indexed_votes_walk_ref` — the paper's algorithm in plain
    PyTorch: walk the inclusion lists ``lists (m, 2o, cap)`` of the false
    literals and OR "false" into each listed clause. It is the registry's
    plain body, so CPU tensors take it.
  * :func:`indexed_votes` — the hand-written CUDA kernel
    (``csrc/indexed_votes.cu``) that replaces the TPU kernel
    ``_indexed_votes_kernel`` (``src/repro/kernels/indexed.py:103``). It
    walks the lists too, in thread-block clusters that split the literal
    axis; see the source for the design. Its geometry is
    :func:`walk_plan`, a pure function the CPU tests check.

A list cannot be walked when its count exceeds the capacity (the ids past
it were dropped from ``lists`` and live only in ``pos``), or when its used
prefix has a hole (the batched replay leaves one in a list that once
overflowed and has shrunk since). Both walks cover such a list from the
column ``pos[i, :, k] != NA`` instead, so all three bodies agree on every
``ClauseIndex`` the port builds or replays, list order included: only
:func:`build_index` writes ascending ids, and nothing assumes it.

Index maintenance, :func:`index_update_batched`, is PyTorch tensor code on
both devices: the reference has no Pallas body for it either (its registry
routes both backends to one XLA body), and the port has no kernel for it.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.clause_eval import SMEM_LIMIT, SMS

# Mirrors core.indexing.NA — the ClauseIndex layout's "excluded" sentinel.
NA = -1

THREADS = 1024              # threads of one walk block (csrc: kThreads)
CLUSTER = 8                 # blocks of a cluster, splitting the literal axis
MAX_CLUSTER = 16            # past 8 the card needs a non-portable cluster
MAX_WINDOW = 16_384         # clause ids per block bitmask: 64 KB of shared
_STATIC_SMEM = 3 * 4 * THREADS + 4 + 4 * 32   # the kernel's staged lists
_MAX_GRID_Z = 65_535


def indexed_votes_ref(pos: torch.Tensor, lit: torch.Tensor,
                      pol: torch.Tensor) -> torch.Tensor:
    """(m, n, 2o) positions + (B, 2o) literals + (n,) ±1 polarity →
    (B, m) int32 vote sums ``-Σ_{j falsified} pol_j`` (plain PyTorch, the
    matmul form)."""
    m, n, L = pos.shape
    member = (pos != NA).reshape(m * n, L)
    false_lit = (lit == 0)
    hits = torch.matmul(false_lit.to(torch.float32),
                        member.to(torch.float32).T)          # (B, m·n)
    falsified = (hits > 0).reshape(-1, m, n)
    return -(falsified.to(torch.int32) * pol.to(torch.int32)).sum(
        -1, dtype=torch.int32)


def _prefixes(lists: torch.Tensor, counts: torch.Tensor, n: int):
    """(entries, ok): (m, 2o, cap) bool marking the valid ids of each used
    prefix ``min(counts, cap)``, and (m, 2o) bool :func:`walkable`."""
    cap = lists.shape[-1]
    used = torch.arange(cap, device=lists.device) < counts.clamp(max=cap)[..., None]
    valid = (lists >= 0) & (lists < n)
    ok = (counts <= cap) & ~(used & ~valid).any(-1)
    return used & valid, ok


def walkable(lists: torch.Tensor, counts: torch.Tensor,
             n: int) -> torch.Tensor:
    """(m, 2o) bool: the lists whose used prefix ``min(counts, cap)`` holds
    every member — count within the capacity and no hole (an id that is
    ``NA`` or out of ``[0, n)``) in the prefix. The kernel decides the same
    per list, on the card."""
    return _prefixes(lists, counts, n)[1]


def indexed_votes_walk_ref(lists: torch.Tensor, counts: torch.Tensor,
                           pos: torch.Tensor, lit: torch.Tensor,
                           pol: torch.Tensor) -> torch.Tensor:
    """The paper's list walk in plain PyTorch: (B, m) int32 votes, the
    contract of :func:`indexed_votes_ref` computed from the lists.

    The used entries ``(i, k, j)`` of the lists of literals false in some
    sample are gathered once; a list that cannot be walked
    (:func:`walkable`) adds its column of ``pos`` instead. Each sample then
    ORs ``lit[b, k] == 0`` into its (m·n) falsified row by
    ``scatter_reduce`` (max over 0/1), and the votes are
    ``-Σ_j falsified · pol``.
    """
    m, L, cap = lists.shape
    n = pos.shape[1]
    b = lit.shape[0]
    false_lit = lit == 0                                          # (B, L)
    hot = false_lit.any(0)[None, :]                               # (1, L)
    entries, ok = _prefixes(lists, counts, n)
    ii, kk, ss = torch.nonzero(entries & hot[..., None], as_tuple=True)
    jj = lists[ii, kk, ss].long()
    # lists the walk cannot trust: every member from pos's column
    bi, bk = torch.nonzero(~ok & hot, as_tuple=True)
    bb, bj = torch.nonzero(pos[bi, :, bk] != NA, as_tuple=True)
    ii, kk = torch.cat([ii, bi[bb]]), torch.cat([kk, bk[bb]])
    jj = torch.cat([jj, bj])
    hit = false_lit[:, kk].to(torch.int32)                        # (B, E)
    falsified = torch.zeros((b, m * n), dtype=torch.int32, device=lists.device)
    falsified.scatter_reduce_(1, (ii * n + jj).expand(b, -1), hit, "amax")
    return -(falsified.reshape(b, m, n) * pol.to(torch.int32)).sum(
        -1, dtype=torch.int32)


@dataclasses.dataclass(frozen=True)
class WalkPlan:
    """Geometry of the ``csrc/indexed_votes.cu`` launches.

    Block ``(r, i, z)`` of a cluster of ``cluster`` blocks along x takes
    class ``i``, batch word ``z // n_windows`` (32 samples) and clause ids
    ``[w · window, (w + 1) · window)`` with ``w = z % n_windows``; block
    ``r`` of the cluster walks the lists of literal groups ``r, r +
    cluster, …`` (32 literals a group). The C launcher splits z over
    launches of at most 65535 // ``n_windows`` batch words.
    """

    cluster: int            # blocks per cluster (x)
    window: int             # clause ids per block bitmask
    n_windows: int          # windows over the n clauses
    n_words: int            # batch words of 32 samples
    grid: tuple[int, int, int]   # (cluster, m, n_words · n_windows)
    smem_bytes: int         # shared bytes per block, static + dynamic


def walk_plan(b: int, m: int, n: int, *, window: int | None = None,
              cluster: int | None = None) -> WalkPlan:
    """The launch geometry of :func:`indexed_votes` (pure). ``window``
    defaults to ``min(n, MAX_WINDOW)``; any n runs, in more windows.
    ``cluster`` defaults to ``MAX_CLUSTER`` blocks when the grid then still
    fits one block per SM, else ``CLUSTER``: a block holds 1024 threads
    (one per SM at the kernel's register count), and at m = 2 (IMDb) a
    cluster of 8 leaves the walk of each block's lists on too few SMs."""
    window = min(n, MAX_WINDOW) if window is None else window
    _require(1 <= window and 4 * window + _STATIC_SMEM <= SMEM_LIMIT,
             f"window {window} does not fit a block's shared memory")
    n_windows = -(-n // window)
    _require(n_windows <= _MAX_GRID_Z, f"{n} clauses need {n_windows} windows")
    n_words = -(-b // 32)
    if cluster is None:
        fits = MAX_CLUSTER * m * n_words * n_windows <= SMS
        cluster = MAX_CLUSTER if fits else CLUSTER
    _require(1 <= cluster <= MAX_CLUSTER,
             f"cluster must be in [1, {MAX_CLUSTER}], got {cluster}")
    return WalkPlan(cluster=cluster, window=window, n_windows=n_windows,
                    n_words=n_words,
                    grid=(cluster, m, n_words * n_windows),
                    smem_bytes=4 * window + _STATIC_SMEM)


@functools.cache
def _launcher():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.entry("indexed_votes", "indexed_votes_launch",
                        [p, p, p, p, p, p, i, i, i, i, i, i, i, p])


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"indexed_votes: {msg}")


def indexed_votes(lists: torch.Tensor, counts: torch.Tensor,
                  pos: torch.Tensor, lit: torch.Tensor, pol: torch.Tensor,
                  *, window: int | None = None,
                  cluster: int | None = None) -> torch.Tensor:
    """CUDA kernel: (B, m) int32 falsification votes by a walk of the false
    literals' inclusion lists, equal to :func:`indexed_votes_walk_ref` and
    :func:`indexed_votes_ref` on the same index.

    Takes ``lists`` (m, 2o, cap), ``counts`` (m, 2o), ``pos`` (m, n, 2o),
    ``pol`` (n,), all int32, and ``lit`` (B, 2o) uint8, contiguous on one
    CUDA device, and raises on anything else. ``window`` and ``cluster``
    force the geometry (:func:`walk_plan`). Launches on the current stream
    without synchronising, and never reads a value back to the host.
    """
    _require(lists.is_cuda, f"lists must be a CUDA tensor, got {lists.device}")
    _require(all(t.device == lists.device for t in (counts, pos, lit, pol)),
             f"operands on different devices: lists {lists.device}, counts "
             f"{counts.device}, pos {pos.device}, lit {lit.device}, pol "
             f"{pol.device}")
    _require(lists.dtype == torch.int32 and lists.dim() == 3,
             f"lists must be (m, 2o, cap) int32, got {tuple(lists.shape)} "
             f"{lists.dtype}")
    m, L, cap = lists.shape
    _require(counts.dtype == torch.int32 and tuple(counts.shape) == (m, L),
             f"counts must be ({m}, {L}) int32, got {tuple(counts.shape)} "
             f"{counts.dtype}")
    _require(pos.dtype == torch.int32 and pos.dim() == 3
             and pos.shape[0] == m and pos.shape[2] == L,
             f"pos must be ({m}, n, {L}) int32, got {tuple(pos.shape)} "
             f"{pos.dtype}")
    n = pos.shape[1]
    _require(lit.dtype == torch.uint8 and lit.dim() == 2 and lit.shape[1] == L,
             f"lit must be (B, {L}) uint8, got {tuple(lit.shape)} {lit.dtype}")
    _require(pol.dtype == torch.int32 and tuple(pol.shape) == (n,),
             f"pol must be ({n},) int32, got {tuple(pol.shape)} {pol.dtype}")
    _require(all(t.is_contiguous() for t in (lists, counts, pos, lit, pol)),
             "operands must be contiguous")
    b = lit.shape[0]
    if b == 0 or m == 0 or n == 0 or L == 0:
        return torch.zeros((b, m), dtype=torch.int32, device=lists.device)
    plan = walk_plan(b, m, n, window=window, cluster=cluster)
    # one window stores every cell; more windows add into zeros
    out = (torch.empty if plan.n_windows == 1 else torch.zeros)(
        (b, m), dtype=torch.int32, device=lists.device)
    launch = _launcher()
    with torch.cuda.device(lists.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = launch(lists.data_ptr(), counts.data_ptr(), pos.data_ptr(),
                      lit.data_ptr(), pol.data_ptr(), out.data_ptr(), m, n, L,
                      b, cap, plan.window, plan.cluster, stream)
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
