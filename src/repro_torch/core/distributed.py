"""Clause- and data-sharded TM execution — port of ``repro.core.distributed``.

The Massively Parallel TM recipe (Abeyrathna et al., 2020): split the
*clauses* over ranks, evaluate each shard locally, reduce the per-class
vote. The reference runs it as ``shard_map`` programs over a JAX mesh with
``psum``; the port keeps its single-controller shape. One process holds a
(data × model) grid of devices (``launch/mesh.py``), each rank's state slice
and engine caches live on its device (``ShardedBundle``), and every
``psum`` becomes a *reduction*: the ranks' int32 partials summed in a fixed
rank order on one device and copied back to the others. Every partial is
int32 (votes, TA deltas, overflow counts, the one-owner reassembly), so the
order cannot change a result and sharded runs are bit-exact with one
device. A mesh may repeat a device: k shards can share one card, which runs
them one after another.

  * ``make_sharded_prepare`` — caches built per clause shard from the
    shard's state slice (``EvalEngine.shard_prepare``): no device holds a
    full cache.
  * ``make_sharded_scores`` — the batch splits over data ranks, each rank
    scores its rows against its clause shard (``partial_scores``), and the
    partials are summed over clause shards: one reduction per call.
  * ``make_sharded_train_step`` — Type I/II feedback on each rank's clause
    rows with the vote of every round reduced over the ranks that hold
    clause rows (``tm.learn_batch``), then each shard diffs its own include
    mask into its own event buffer (``max_events`` per shard) and replays
    it into its own caches. Sequential learning keeps the global sample
    order; with data ranks it composes them with the clause axis (each
    data rank owns a sub-slice of ``⌈n_local/D⌉`` rows of every clause
    shard, reassembled by ownership after the batch), or, when ``D`` exceeds
    the rows of a shard, replicates (``replicated``, warned). Batch-parallel
    learning splits the batch over data ranks and sums their int32 deltas
    before one clip.
  * ``async_votes=K`` (``make_sharded_train_step`` + ``make_vote_refresh``):
    each round reads ``live local vote + stale`` and reduces nothing; one
    packed ``(m+1,)`` reduction per K steps refreshes the stale terms and
    drains the per-rank overflow counts (``VoteAccumulator``).

Ragged geometry: any ``(data_shards, clause_shards, n_clauses)`` works. The
clause axis pads to ``clause_shards · ⌈n_clauses/clause_shards⌉`` rows
(``ClauseGeometry``); padding rows sit at state N (empty clauses), carry
polarity 0 (no vote through any engine or kernel) and are frozen by the
clause mask (``active &= clause_mask``), so no kernel changes for them.

Every factory's function counts its reductions in ``.reductions``, the
port's counterpart of the collective counts that the reference's
``dryrun --tm`` reads from the lowered HLO. The reference's
``cache_pspec`` / ``bundle_pspecs`` / ``STATE_PSPEC`` (how arrays lay out
over a mesh) have no counterpart: a rank holds whole tensors.
"""
from __future__ import annotations

import dataclasses
import warnings

import torch

from repro_torch.core import indexing, tm
from repro_torch.core.api import DEFAULT_ENGINE, TMBundle, cache_keys_for
from repro_torch.core.engines import cache_provider, get_engine
from repro_torch.core.types import (
    TMConfig, TMState, VoteAccumulator, clause_polarity, include_mask)
from repro_torch.spans import span

# Sequential-composition rule names (the reference's resolution table).
COMPOSED_EVEN = "composed_even"      # n_local divides by data_shards
COMPOSED_RAGGED = "composed_ragged"  # ragged sub-slices (zero-padded)
REPLICATED = "replicated"            # data_shards > n_local
CLAUSE_ONLY = "clause_only"          # data_shards == 1: nothing to compose


@dataclasses.dataclass(frozen=True)
class ClauseGeometry:
    """Ragged clause-axis geometry of one ``(cfg × mesh)`` resolution.

    The clause axis pads to ``n_padded = clause_shards · n_local`` rows
    (``n_local = ⌈n_clauses/clause_shards⌉``); rows ``>= n_clauses`` are
    padding, all on the trailing shard(s). Under sequential data × clause
    composition each data rank owns ``n_sub = ⌈n_local/data_shards⌉`` rows
    of its shard's (re-padded) slice. ``composition`` names the rule.
    """

    n_clauses: int
    clause_shards: int
    data_shards: int
    n_local: int
    n_padded: int
    n_sub: int
    composition: str

    @property
    def ragged_clauses(self) -> bool:
        """True when the global clause axis itself carries padding rows."""
        return self.n_padded != self.n_clauses

    @property
    def composes(self) -> bool:
        """True when sequential learning splits clause work over data ranks."""
        return self.composition in (COMPOSED_EVEN, COMPOSED_RAGGED)

    @property
    def n_sub_padded(self) -> int:
        """Per-shard clause rows after sub-slice padding (≥ ``n_local``)."""
        return self.data_shards * self.n_sub if self.composes else self.n_local

    def shard_rows(self) -> list[dict]:
        """Per-clause-shard row census ``[{shard, real_rows, pad_rows}]``:
        shard ``i`` owns ``clamp(n_clauses − i·n_local, 0, n_local)`` real
        rows."""
        rows = []
        for i in range(self.clause_shards):
            real = min(max(self.n_clauses - i * self.n_local, 0), self.n_local)
            rows.append({"shard": i, "real_rows": real,
                         "pad_rows": self.n_local - real})
        return rows


def clause_geometry(n_clauses: int, clause_shards: int,
                    data_shards: int) -> ClauseGeometry:
    """Resolve the ragged geometry and the sequential composition rule
    (pure in its three integers)."""
    n_local = -(-n_clauses // clause_shards)
    n_padded = clause_shards * n_local
    if data_shards <= 1:
        rule, n_sub = CLAUSE_ONLY, n_local
    elif n_local % data_shards == 0:
        rule, n_sub = COMPOSED_EVEN, n_local // data_shards
    elif data_shards <= n_local:
        rule, n_sub = COMPOSED_RAGGED, -(-n_local // data_shards)
    else:  # more data ranks than clause rows: no sub-slice to hand out
        rule, n_sub = REPLICATED, n_local
    return ClauseGeometry(
        n_clauses=n_clauses, clause_shards=clause_shards,
        data_shards=data_shards, n_local=n_local, n_padded=n_padded,
        n_sub=n_sub, composition=rule)


def geometry(cfg: TMConfig, mesh) -> ClauseGeometry:
    """``clause_geometry`` of a config on a ``DeviceMesh``."""
    return clause_geometry(cfg.n_clauses, mesh.model, mesh.data)


def _pad_rows(t: torch.Tensor, dim: int, size: int, value) -> torch.Tensor:
    """``t`` padded along ``dim`` up to ``size`` rows of ``value``."""
    pad = size - t.shape[dim]
    if pad == 0:
        return t
    shape = list(t.shape)
    shape[dim] = pad
    return torch.cat([t, torch.full(shape, value, dtype=t.dtype,
                                    device=t.device)], dim=dim)


def pad_state(cfg: TMConfig, state: TMState, n_padded: int) -> TMState:
    """Pad the clause axis of a global state to the sharded layout with rows
    at state N (every TA excludes: an empty clause, in no cache). Idempotent
    on an already padded state."""
    n = state.ta_state.shape[1]
    if n == n_padded:
        return state
    if n != cfg.n_clauses:
        raise ValueError(
            f"state has {n} clause rows; expected n_clauses="
            f"{cfg.n_clauses} (unpadded) or {n_padded} (padded)")
    return TMState(ta_state=_pad_rows(state.ta_state, 1, n_padded,
                                      cfg.n_states))


def unpad_state(cfg: TMConfig, state: TMState) -> TMState:
    """Drop clause-axis padding rows: the global ``(m, n_clauses, 2o)`` view."""
    if state.ta_state.shape[1] == cfg.n_clauses:
        return state
    return TMState(ta_state=state.ta_state[:, :cfg.n_clauses, :])


def sharded_polarity(cfg: TMConfig, geom: ClauseGeometry) -> torch.Tensor:
    """Global (n_padded,) int32 polarity on the CPU, 0 on padding rows: a
    padding clause's output times 0 adds nothing to any partial vote."""
    return _pad_rows(clause_polarity(cfg, "cpu"), 0, geom.n_padded, 0)


def _polarity_grid(cfg: TMConfig, mesh, geom: ClauseGeometry):
    """[d][c] → clause shard c's polarity slice on rank (d, c)'s device."""
    pol, n = sharded_polarity(cfg, geom), geom.n_local
    return [[pol[c * n:(c + 1) * n].to(mesh.device(d, c)).contiguous()
             for c in range(mesh.model)] for d in range(mesh.data)]


def _local_valid(cfg: TMConfig, start: int, rows: int, limit: int,
                 device) -> torch.Tensor | None:
    """(rows,) bool: row ``r`` is real iff ``r < limit`` and its global row
    ``start + r`` is below ``n_clauses``; None when every row is real."""
    if rows <= limit and start + rows <= cfg.n_clauses:
        return None
    r = torch.arange(rows, device=device)
    return (r < limit) & (start + r < cfg.n_clauses)


def _reduce(groups: list[list[torch.Tensor]]) -> list[torch.Tensor]:
    """Each group's tensors summed in rank order on its first tensor's
    device (exact: integer partials)."""
    out = []
    for g in groups:
        dev = g[0].device
        out.append(g[0] if len(g) == 1 else
                   torch.stack([t.to(dev) for t in g]).sum(0, dtype=g[0].dtype))
    return out


def _allreduce(groups: list[list[torch.Tensor]]) -> list[list[torch.Tensor]]:
    """:func:`_reduce`, with each group's total copied back to every
    member's device (a no-op where a member shares the first's device)."""
    return [[total.to(t.device) for t in g]
            for g, total in zip(groups, _reduce(groups))]


# ---------------------------------------------------------------------------
# The sharded bundle
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardedBundle:
    """A TM bundle over a mesh: one ``TMBundle`` per (data, clause) rank.

    ``ranks[d][c]`` holds clause shard ``c``'s (m, n_local, 2o) state slice
    and its engine caches on the rank's device, and, under asynchronous
    learning, the rank's ``(1, m)`` ``VoteAccumulator`` row. Data ranks of
    one clause shard hold equal states and caches; ranks on one device
    share the tensors. ``event_overflow`` is the global count of dropped
    cache-sync events, on the first rank's device.
    """

    cfg: TMConfig
    mesh: object
    geometry: ClauseGeometry
    ranks: tuple[tuple[TMBundle, ...], ...]
    event_overflow: torch.Tensor

    def rank(self, d: int, c: int) -> TMBundle:
        """Rank (data ``d``, clause ``c``)'s bundle."""
        return self.ranks[d][c]

    @property
    def state(self) -> TMState:
        """The padded global ``(m, n_padded, 2o)`` state, assembled on the
        first rank's device (``TMSession.unpad_state`` drops the padding)."""
        dev = self.mesh.device(0, 0)
        return TMState(ta_state=torch.cat(
            [r.state.ta_state.to(dev) for r in self.ranks[0]], dim=1))

    @property
    def caches(self) -> dict:
        """``{cache_key: (clause shard 0's cache, …)}`` of data rank 0."""
        return {k: tuple(r.caches[k] for r in self.ranks[0])
                for k in self.ranks[0][0].caches}

    @property
    def index(self) -> tuple[indexing.ClauseIndex, ...]:
        """Each clause shard's falsification index (local clause ids)."""
        return self.caches["indexed"]

    @property
    def vote_acc(self) -> VoteAccumulator | None:
        """The ranks' accumulator rows stacked data-major, clause-minor into
        ``(R, m)`` / ``(R,)`` on the first rank's device; None when the
        bundle learns synchronously."""
        rows = [r.vote_acc for row in self.ranks for r in row]
        if rows[0] is None:
            return None
        dev = self.mesh.device(0, 0)
        return VoteAccumulator(*(torch.cat([getattr(a, f).to(dev) for a in rows])
                                 for f in VoteAccumulator._fields))


def _zero_acc(cfg: TMConfig, device) -> VoteAccumulator:
    zeros = torch.zeros((1, cfg.n_classes), dtype=torch.int32, device=device)
    return VoteAccumulator(local=zeros, stale=zeros.clone(),
                           overflow=torch.zeros((1,), dtype=torch.int32,
                                                device=device))


def init_vote_acc(cfg: TMConfig, mesh) -> list[list[VoteAccumulator]]:
    """Fresh all-zero accumulator rows, ``[d][c]`` on each rank's device.
    Zeros are the right cold start: the first window reads local votes
    alone, and the first refresh replaces them with real sums."""
    return [[_zero_acc(cfg, mesh.device(d, c)) for c in range(mesh.model)]
            for d in range(mesh.data)]


def _per_device(mesh, c: int, build):
    """``build(d, device)`` once per distinct device among clause shard
    ``c``'s data ranks (``d`` the first data rank on it); returns the
    results in data-rank order."""
    done = {}
    out = []
    for d in range(mesh.data):
        dev = mesh.device(d, c)
        if dev not in done:
            done[dev] = build(d, dev)
        out.append(done[dev])
    return out


def make_sharded_prepare(cfg: TMConfig, mesh, *, engines=None,
                         async_votes: int = 0):
    """``(TMState) -> ShardedBundle`` with every engine's cache built per
    clause shard from the shard's state slice, on each rank's device.
    ``async_votes > 0`` seeds the accumulator rows with zeros."""
    geom = geometry(cfg, mesh)
    keys = cache_keys_for(engines)
    n = geom.n_local

    def prepare(state: TMState) -> ShardedBundle:
        padded = pad_state(cfg, state, geom.n_padded).ta_state
        accs = init_vote_acc(cfg, mesh) if async_votes > 0 else None
        grid = [[None] * mesh.model for _ in range(mesh.data)]
        for c in range(mesh.model):
            def build(d, dev, c=c):
                ta = padded[:, c * n:(c + 1) * n].to(
                    device=dev, dtype=cfg.state_dtype).contiguous()
                st = TMState(ta_state=ta)
                return st, {k: cache_provider(k).shard_prepare(
                    cfg, st, geom.clause_shards) for k in keys}

            for d, (st, caches) in enumerate(_per_device(mesh, c, build)):
                grid[d][c] = TMBundle(
                    cfg=cfg, state=st, caches=caches,
                    vote_acc=accs[d][c] if accs is not None else None)
        return ShardedBundle(
            cfg=cfg, mesh=mesh, geometry=geom,
            ranks=tuple(tuple(row) for row in grid),
            event_overflow=torch.zeros((), dtype=torch.int32,
                                       device=mesh.device(0, 0)))

    return prepare


def make_sharded_scores(cfg: TMConfig, mesh, *, engine: str = DEFAULT_ENGINE):
    """``(ShardedBundle, x) -> (B, m)`` scores through one engine.

    ``x`` (B, o) uint8, ``B`` a multiple of ``data_shards``: data rank ``d``
    takes rows ``[d·B/D, (d+1)·B/D)``, each of its clause ranks scores them
    against its shard (``partial_scores``, polarity 0 on padding rows), and
    one reduction sums the partials over clause shards for every data rank
    at once. The result lands on the first rank's device. ``operands`` /
    ``evaluate`` split a call so that a serving bucket resolves the ranks'
    caches once (``TMSession.lower_scores``).
    """
    eng = get_engine(engine)
    pols = _polarity_grid(cfg, mesh, geometry(cfg, mesh))
    out_dev = mesh.device(0, 0)

    def operands(bundle: ShardedBundle):
        """[d][c] → what rank (d, c) scores from: its state for cache-less
        engines, its cache otherwise (raises when the slot is missing:
        sharded caches are never built on the fly)."""
        def one(rank: TMBundle):
            if not eng.needs_cache:
                return rank.state
            cache = rank.caches.get(eng.cache_key)
            if cache is None:
                raise KeyError(
                    f"engine {engine!r} (cache slot {eng.cache_key!r}) was "
                    f"not prepared in this bundle (slots: "
                    f"{tuple(rank.caches)}); include it in the session's "
                    "engines=: sharded caches are not built on the fly")
            return cache
        return [[one(r) for r in row] for row in bundle.ranks]

    def evaluate(ops, x: torch.Tensor) -> torch.Tensor:
        """Scores of ``x`` from :func:`operands`' grid."""
        b = x.shape[0]
        if b % mesh.data:
            raise ValueError(f"batch of {b} rows does not split over "
                             f"data_shards={mesh.data}")
        rows = b // mesh.data
        parts = []
        for d in range(mesh.data):
            xd = x[d * rows:(d + 1) * rows]
            parts.append([eng.partial_scores(cfg, ops[d][c],
                                             xd.to(mesh.device(d, c)),
                                             pols[d][c])
                          for c in range(mesh.model)])
        totals = _reduce(parts)
        scores.reductions += mesh.model > 1
        if len(totals) == 1:
            return totals[0].to(out_dev)
        return torch.cat([t.to(out_dev) for t in totals])

    def scores(bundle: ShardedBundle, x: torch.Tensor) -> torch.Tensor:
        return evaluate(operands(bundle), x)

    scores.reductions = 0
    scores.operands, scores.evaluate = operands, evaluate
    return scores


# ---------------------------------------------------------------------------
# Learning
# ---------------------------------------------------------------------------


def make_sharded_train_step(cfg: TMConfig, mesh, *, engines=None,
                            parallel: bool = False, max_events: int = 4096,
                            async_votes: int = 0):
    """``(ShardedBundle, xs, ys, draws[, mask]) -> ShardedBundle``.

    ``draws`` is the batch's full-size ``SampleDraws`` or a
    ``torch.Generator`` read in ``tm.draw_sample_draws``'s order; every
    rank takes its rows of every draw, so the step is bit-exact with
    ``api.train_step`` on one device.

    Which ranks run rounds (the composition rule):

      * ``clause_only`` (D = 1): the C clause ranks, the full batch each;
      * ``composed_even`` / ``composed_ragged``: all C·D ranks, rank (d, c)
        on rows ``[d·n_sub, (d+1)·n_sub)`` of shard c padded to
        ``D·n_sub`` rows; after the batch one reduction reassembles each
        shard (each real row has one owner);
      * ``replicated`` (D > n_local, warned): data ranks replicate the
        batch, so the step runs on data rank 0's ranks and copies the result;
      * ``batch_parallel``: data rank d takes batch rows
        ``[d·B/D, (d+1)·B/D)`` on all C clause ranks; after the batch one
        reduction sums the int32 deltas over data ranks, then one clip.

    Synchronous: every round's vote is one reduction over the ranks that
    hold the round's clause rows (all C·D under composition, a data rank's
    C otherwise), and one reduction per step sums the shards' overflow
    counts (each shard's drops once, not once per data rank).
    ``async_votes > 0``: rounds read ``live local vote + stale`` from the
    rank's accumulator row and reduce nothing; the row's ``local`` becomes
    the batch mean of its local votes per touched class (float32, rounded
    half to even, as ``jnp.round``) and its ``overflow`` counts the shard's
    drops until the next refresh (``make_vote_refresh``).
    """
    geom = geometry(cfg, mesh)
    n_local, n_sub = geom.n_local, geom.n_sub
    C, D = mesh.model, mesh.data
    compose = not parallel and geom.composes
    if not parallel and geom.composition == REPLICATED:
        warnings.warn(
            f"sequential sharded training fired composition rule "
            f"'{REPLICATED}': data_shards={D} exceeds the per-shard clause "
            f"count n_local={n_local} (n_clauses={cfg.n_clauses} / "
            f"clause_shards={C}), so there is no clause sub-slice to hand "
            "each data rank — the data axis replicates the batch instead of "
            "adding clause parallelism. Pick data_shards <= n_local to "
            f"compose (rules '{COMPOSED_EVEN}'/'{COMPOSED_RAGGED}').",
            RuntimeWarning, stacklevel=2)
    keys = cache_keys_for(engines)
    pols = _polarity_grid(cfg, mesh, geom)
    pad_pols = [[_pad_rows(p, 0, geom.n_sub_padded, 0) for p in row]
                for row in pols]

    def reduce(votes: list[torch.Tensor]) -> list[torch.Tensor]:
        step.reductions += 1
        return _allreduce([votes])[0]

    def workers(bundle: ShardedBundle) -> list[list[tm.ShardRows]]:
        """The ranks that run rounds this step, grouped by data rank."""
        def stale(d, c):
            acc = bundle.ranks[d][c].vote_acc
            return acc.stale[0] if async_votes > 0 else None

        def shard_rows(d, c, ta, start, rows, limit):
            dev = mesh.device(d, c)
            pol = (pad_pols[d][c][d * n_sub:(d + 1) * n_sub] if compose
                   else pols[d][c])
            return tm.ShardRows(
                ta=ta, pol=pol, start=start,
                clause_mask=_local_valid(cfg, start, rows, limit, dev),
                stale=stale(d, c),
                acc=(torch.zeros(ta.shape, dtype=torch.int32, device=dev)
                     if parallel else None))

        if parallel:
            return [[shard_rows(d, c, bundle.ranks[d][c].state.ta_state,
                                c * n_local, n_local, n_local)
                     for c in range(C)] for d in range(D)]
        if compose:
            group = []
            for d in range(D):
                for c in range(C):
                    ta = _pad_rows(bundle.ranks[d][c].state.ta_state, 1,
                                   geom.n_sub_padded, cfg.n_states)
                    ta = ta[:, d * n_sub:(d + 1) * n_sub].clone(
                        memory_format=torch.contiguous_format)
                    group.append(shard_rows(d, c, ta, c * n_local + d * n_sub,
                                            n_sub, n_local - d * n_sub))
            return [group]
        return [[shard_rows(0, c, bundle.ranks[0][c].state.ta_state.clone(),
                            c * n_local, n_local, n_local) for c in range(C)]]

    def new_shards(groups) -> list[torch.Tensor]:
        """Clause shard c's new (m, n_local, 2o) state, on rank (0, c)."""
        if parallel:
            deltas = _reduce([[groups[d][c].acc for d in range(D)]
                              for c in range(C)])
            step.reductions += D > 1
            return [torch.clamp(groups[0][c].ta.to(torch.int32) + deltas[c],
                                1, 2 * cfg.n_states).to(cfg.state_dtype)
                    for c in range(C)]
        if compose:
            step.reductions += 1   # the reassembly
            rows = groups[0]
            return [torch.cat([rows[d * C + c].ta.to(mesh.device(0, c))
                               for d in range(D)], dim=1)[:, :n_local]
                    .contiguous() for c in range(C)]
        return [r.ta for r in groups[0]]

    def vote_rows(groups):
        """[d][c] → the ShardRows whose vote statistics rank (d, c) keeps."""
        if parallel:
            return groups
        if compose:
            return [[groups[0][d * C + c] for c in range(C)] for d in range(D)]
        return [groups[0]] * D      # clause-only, or replicated data ranks

    def step(bundle: ShardedBundle, xs, ys, draws, mask=None) -> ShardedBundle:
        if async_votes > 0 and bundle.ranks[0][0].vote_acc is None:
            raise ValueError(
                "async_votes > 0 needs a bundle carrying a VoteAccumulator: "
                "prepare it with make_sharded_prepare(..., async_votes=K) "
                "(or let TMSession.prepare do it)")
        groups = workers(bundle)
        tm.learn_batch(cfg, groups, xs, ys, draws, mask=mask,
                       parallel=parallel, reduce=reduce)
        shards = new_shards(groups)
        stats = vote_rows(groups) if async_votes > 0 else None
        grid = [[None] * C for _ in range(D)]
        overflow = []
        for c in range(C):
            def sync(d, dev, c=c):
                old = bundle.ranks[d][c]
                st = TMState(ta_state=shards[c].to(dev))
                with span("tm.index_sync.diff"):
                    buf = indexing.events_from_transition(
                        include_mask(cfg, old.state), include_mask(cfg, st),
                        max_events)
                with span("tm.index_sync.apply"):
                    caches = {k: cache_provider(k).update_cache(
                        cfg, old.caches[k], st, buf.events) for k in keys}
                return st, caches, buf.overflow

            for d, (st, caches, dropped) in enumerate(
                    _per_device(mesh, c, sync)):
                if d == 0:
                    overflow.append(dropped)
                acc = bundle.ranks[d][c].vote_acc
                if stats is not None:
                    acc = _write_buffer(acc, *stats[d][c].vote_stats, dropped)
                grid[d][c] = TMBundle(cfg=cfg, state=st, caches=caches,
                                      vote_acc=acc)
        event_overflow = bundle.event_overflow
        if async_votes == 0:
            step.reductions += C > 1
            event_overflow = event_overflow + _reduce([overflow])[0].to(
                event_overflow.device)
        return ShardedBundle(cfg=cfg, mesh=mesh, geometry=geom,
                             ranks=tuple(tuple(row) for row in grid),
                             event_overflow=event_overflow)

    step.reductions = 0
    return step


def _write_buffer(acc: VoteAccumulator, vs: torch.Tensor, vc: torch.Tensor,
                  dropped: torch.Tensor) -> VoteAccumulator:
    """A rank's accumulator row after an asynchronous step: per touched
    class the batch mean of its local votes, ``round(vs / max(vc, 1))`` in
    float32, half to even (untouched classes keep their value); the
    shard's dropped events add to ``overflow``."""
    dev = acc.local.device
    vs, vc = vs.to(dev), vc.to(dev)
    mean = torch.round(vs.to(torch.float32)
                       / vc.clamp(min=1).to(torch.float32)).to(torch.int32)
    local = torch.where(vc > 0, mean, acc.local[0])[None]
    return VoteAccumulator(local=local, stale=acc.stale,
                           overflow=acc.overflow + dropped.to(dev))


def make_vote_refresh(cfg: TMConfig, mesh, *, parallel: bool = False):
    """``(ShardedBundle) -> ShardedBundle``: the K-step stale-vote refresh.

    One reduction: each rank packs its ``(m,)`` local votes and its
    overflow count into one ``(m+1,)`` vector. Under sequential
    composition every rank owns distinct clause rows, so the vectors sum
    over all ranks, and only data rank 0 contributes overflow (the data
    ranks of a shard count the same drops); otherwise data ranks replicate
    clause rows and each data rank's vectors sum over its clause ranks.
    After it, ``stale = total − own local``, each rank's overflow is 0, and
    the bundle's ``event_overflow`` has absorbed the window's drops.
    """
    geom = geometry(cfg, mesh)
    compose = not parallel and geom.composes
    m, C, D = cfg.n_classes, mesh.model, mesh.data

    def refresh(bundle: ShardedBundle) -> ShardedBundle:
        if bundle.ranks[0][0].vote_acc is None:
            raise ValueError("refresh needs a bundle with a VoteAccumulator")
        packed = []
        for d in range(D):
            for c in range(C):
                acc = bundle.ranks[d][c].vote_acc
                oflow = acc.overflow if (d == 0 or not compose) else \
                    torch.zeros_like(acc.overflow)
                packed.append(torch.cat([acc.local[0], oflow]))
        groups = ([packed] if compose else
                  [packed[d * C:(d + 1) * C] for d in range(D)])
        totals = [t for g in _allreduce(groups) for t in g]
        refresh.reductions += 1
        grid = [[None] * C for _ in range(D)]
        for d in range(D):
            for c in range(C):
                rank, total = bundle.ranks[d][c], totals[d * C + c]
                acc = rank.vote_acc
                grid[d][c] = dataclasses.replace(rank, vote_acc=VoteAccumulator(
                    local=acc.local, stale=(total[:m] - acc.local[0])[None],
                    overflow=torch.zeros_like(acc.overflow)))
        drained = totals[0][m].to(bundle.event_overflow.device)
        return dataclasses.replace(
            bundle, ranks=tuple(tuple(row) for row in grid),
            event_overflow=bundle.event_overflow + drained)

    refresh.reductions = 0
    return refresh
