"""Tsetlin Machine forward pass and learning (paper §2) — port of
``repro.core.tm``.

Forward: ``dense_clause_outputs``, ``clause_votes``, ``scores``,
``predict``, ``accuracy``. Learning: Type I / Type II feedback, one class
round at a time in two halves (``_round_vote``: the rows' clause outputs
and partial vote through the ``round_vote`` primitive; ``_round_feedback``:
the clamped vote gates the ``ta_update`` primitive), per sample
(``update_sample``) and per batch, sequentially as the paper learns
(``update_batch_sequential``) or batch-parallel (``update_batch_parallel``),
on one device or over clause shards (``learn_batch``).

Randomness comes in as explicit uniforms (``FeedbackRands``,
``SampleDraws``), like the reference's, so a test can hand both packages
the same draws. In production the draws come from a ``torch.Generator`` in
the order :func:`draw_sample_draws` documents; ``jax.random`` cannot be
replayed in PyTorch, so the two packages agree under injected draws only.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.bitpack import pack_bits
from repro_torch.core.types import (
    TMConfig,
    TMState,
    clause_polarity,
    include_mask,
    literals_from_input,
)
from repro_torch.kernels import backend as kbackend
from repro_torch.spans import span


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


# ---------------------------------------------------------------------------
# Learning: Type I / Type II feedback (paper §2, Granmo 2018 semantics)
# ---------------------------------------------------------------------------


class FeedbackRands(NamedTuple):
    """Uniform draws consumed by one class round of feedback."""

    clause_gate: torch.Tensor  # (n,)     float32, against the update probability p
    type_i: torch.Tensor       # (n, 2o)  float32, against 1/s and 1 - 1/s


class SampleDraws(NamedTuple):
    """The randomness of one sample's update — or, with a leading ``B`` axis
    on every field, of a batch's.

    ``neg_raw`` is the raw negative-class draw, uniform on ``[0, m-1)``;
    the update shifts it past the label (``neg >= y → neg + 1``), as the
    reference does, so the negative class is uniform over the other classes.
    """

    neg_raw: torch.Tensor      # () / (B,) int64
    target: FeedbackRands      # the label's class round (positive feedback)
    other: FeedbackRands       # the negative class's round

    def sample(self, b: int) -> "SampleDraws":
        """Sample ``b``'s draws out of a batch's."""
        return SampleDraws(self.neg_raw[b],
                           FeedbackRands(*(t[b] for t in self.target)),
                           FeedbackRands(*(t[b] for t in self.other)))


def draw_feedback_rands(cfg: TMConfig, generator: torch.Generator) -> FeedbackRands:
    """One class round's uniforms from ``generator`` (gate, then Type I),
    on the generator's device."""
    dev = generator.device
    return FeedbackRands(
        clause_gate=torch.rand((cfg.n_clauses,), generator=generator, device=dev),
        type_i=torch.rand((cfg.n_clauses, cfg.n_literals), generator=generator,
                          device=dev))


def draw_negatives(cfg: TMConfig, generator: torch.Generator,
                   batch: int) -> torch.Tensor:
    """A batch's ``(B,)`` raw negative-class draws, uniform on ``[0, m-1)``."""
    return torch.randint(0, cfg.n_classes - 1, (batch,), generator=generator,
                         device=generator.device)


def draw_sample_draws(cfg: TMConfig, generator: torch.Generator,
                      batch: int) -> SampleDraws:
    """A whole batch's draws, materialised (``B·2·n·(2o+1)`` float32s).

    The order is the one the batch updates follow when they draw for
    themselves, so both give the same numbers from one seed: first the
    batch's ``B`` raw negative-class draws (:func:`draw_negatives`), then per
    sample, in batch order, the target round's and the negative round's
    :func:`draw_feedback_rands`. Masked samples draw too.
    """
    neg = draw_negatives(cfg, generator, batch)
    rounds = [(draw_feedback_rands(cfg, generator),
               draw_feedback_rands(cfg, generator)) for _ in range(batch)]

    def stack(which: int) -> FeedbackRands:
        return FeedbackRands(*(torch.stack([r[which][f] for r in rounds])
                               for f in range(2)))

    return SampleDraws(neg_raw=neg, target=stack(0), other=stack(1))


def _reciprocal_2t(t: float) -> float:
    """float32 ``1 / (2t)``. XLA folds the reference's division by the
    constant ``2t`` into a product with this reciprocal (float32 division of
    float32 values), and ``p`` must match it bit for bit."""
    return float(np.float32(1.0) / np.float32(2.0 * t))


def _slice_rands(rands: FeedbackRands, start: int, n_local: int) -> FeedbackRands:
    """Rows ``[start, start + n_local)`` of a full-size draw.

    Every clause shard reads the same full draw and takes its own rows: the
    one scheme that keeps sharded learning bit-exact with one device. Rows
    past the draw's end clamp to its last row, as the reference's
    ``_slice_rands`` does; they land only on padding rows, which the clause
    mask freezes.
    """
    n = rands.clause_gate.shape[0]
    if start + n_local <= n:
        return FeedbackRands(rands.clause_gate.narrow(0, start, n_local),
                             rands.type_i.narrow(0, start, n_local))
    idx = torch.arange(start, start + n_local,
                       device=rands.clause_gate.device).clamp_(max=n - 1)
    return FeedbackRands(rands.clause_gate.index_select(0, idx),
                         rands.type_i.index_select(0, idx))


def _round_vote(cfg: TMConfig, ta_row: torch.Tensor, lit_words: torch.Tensor,
                pol: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A class round's first half: the rows' (n,) int8 clause outputs
    (learning semantics: an empty clause gives 1) and their partial vote, a
    0-d int32 tensor (no host sync), through the ``round_vote`` primitive.
    ``lit_words`` is the sample's ``(W,)`` packed literals. On the CPU the
    row's include mask is packed every round, as the reference's round
    does; the kernel reads the states themselves."""
    return kbackend.resolve("round_vote")(ta_row.to(torch.int16), lit_words,
                                          pol, n_states=cfg.n_states)


def _round_feedback(cfg: TMConfig, ta_row: torch.Tensor, lit: torch.Tensor,
                    clause_out: torch.Tensor, vote_sum: torch.Tensor,
                    rands: FeedbackRands, positive_round: bool,
                    pol: torch.Tensor, *, clause_mask=None,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """A class round's second half, given the round's vote ``vote_sum``:
    the vote is clamped to ``[-T, T]`` in float32 (as the reference's
    Python-float clip makes it), ``p = (T ∓ vote)/(2T)`` gates each clause
    against its uniform, and ``clause_mask`` (when given) freezes the rows
    it marks False. In the target round positive clauses take Type I
    feedback and the others Type II; the other round swaps them. ``out``
    receives the new row (it may be ``ta_row`` itself)."""
    t = float(cfg.threshold)
    votes = vote_sum.to(torch.float32).clamp(-t, t)
    p = ((t - votes) if positive_round else (t + votes)) * _reciprocal_2t(t)
    active = rands.clause_gate < p                                # (n,)
    if clause_mask is not None:
        active = active & clause_mask
    gets_type_i = (pol > 0) if positive_round else (pol <= 0)
    new = kbackend.resolve("ta_update")(   # the kernel works in int16
        ta_row.to(torch.int16), lit, clause_out, gets_type_i, active,
        rands.type_i, n_states=cfg.n_states, s=cfg.s,
        boost_true_positive=cfg.boost_true_positive,
        out=out if out is not None and out.dtype == torch.int16 else None)
    if out is None:
        return new.to(cfg.state_dtype)
    return out if new is out else out.copy_(new)


def _negative_class(y: int, neg_raw: int) -> int:
    return neg_raw + 1 if neg_raw >= y else neg_raw


def _host_list(values, batch: int) -> list:
    """``batch`` labels, mask bits or draws as Python numbers (one host
    sync for a device tensor)."""
    out = (values if isinstance(values, torch.Tensor)
           else np.asarray(values)).reshape(-1).tolist()
    if len(out) != batch:
        raise ValueError(f"expected {batch} values, got {len(out)}")
    return out


def _batch_draws(cfg: TMConfig, draws, batch: int):
    """(host list of raw negative draws, per-sample round-draw function) from
    a batched ``SampleDraws`` or a ``torch.Generator`` (which is read in
    :func:`draw_sample_draws`'s order, one sample at a time)."""
    if isinstance(draws, torch.Generator):
        negs = draw_negatives(cfg, draws, batch).tolist()

        def rounds(_: int) -> SampleDraws:
            return SampleDraws(None, draw_feedback_rands(cfg, draws),
                               draw_feedback_rands(cfg, draws))

        return negs, rounds
    return _host_list(draws.neg_raw, batch), draws.sample


@dataclasses.dataclass(eq=False)
class ShardRows:
    """One rank's clause rows during a learning step.

    One instance covering a whole state is the single-device step; sharded
    learning (``core/distributed.py``) runs one per rank. ``ta`` (m, rows,
    2o) is the rank's working copy: sequential rounds update it in place;
    batch-parallel rounds only read it and add their deltas into ``acc``
    (int32, same shape). ``pol`` is the rows' polarity (0 on padding rows),
    ``start`` the global clause row of the first row, i.e. which rows of the
    full-size draws it reads (None: the draws have exactly these rows), and
    ``clause_mask`` the real rows (None: all). ``stale`` (m,) int32 makes
    the rounds asynchronous: each reads ``local vote + stale[class]`` and
    nothing is reduced; ``vs`` / ``vc`` then collect each class's local
    votes and round count.
    """

    ta: torch.Tensor
    pol: torch.Tensor
    start: int | None = None
    clause_mask: torch.Tensor | None = None
    stale: torch.Tensor | None = None
    acc: torch.Tensor | None = None
    vs: torch.Tensor | None = None
    vc: list | None = None
    scratch: torch.Tensor | None = None   # a batch-parallel round's new row

    def __post_init__(self):
        if self.stale is not None:
            self.vs = torch.zeros_like(self.stale)
            self.vc = [0] * self.stale.shape[0]
        if self.acc is not None:
            self.scratch = torch.empty_like(self.ta[0])

    @property
    def vote_stats(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``(vs, vc)`` (m,) int32: the summed local votes and round counts
        per class, on the rank's device."""
        return self.vs, torch.tensor(self.vc, dtype=torch.int32,
                                     device=self.vs.device)

    def rands(self, full: FeedbackRands) -> FeedbackRands:
        """This rank's rows of a full-size draw, on its device."""
        if self.start is not None:
            full = _slice_rands(full, self.start, self.ta.shape[1])
        dev = self.ta.device
        return FeedbackRands(full.clause_gate.to(dev), full.type_i.to(dev))


def _vote_sums(rows: list[ShardRows], votes: list[torch.Tensor], cls: int,
               reduce) -> list[torch.Tensor]:
    """The vote each rank's round reads: its own, plus its stale term when
    asynchronous, else the reduction of every rank's partial vote."""
    if rows[0].stale is not None:
        for r, v in zip(rows, votes):
            r.vs[cls] += v
            r.vc[cls] += 1
        return [v + r.stale[cls] for r, v in zip(rows, votes)]
    if len(rows) == 1:
        return votes
    return reduce(votes)


def learn_batch(cfg: TMConfig, groups: list[list[ShardRows]], xs, ys,
                draws: "SampleDraws | torch.Generator", *, mask=None,
                parallel: bool = False, reduce=None) -> None:
    """The class rounds of one batch over ranks of clause rows, in place.

    ``groups`` holds the ranks, one list per data rank. Sequential: one
    group; every sample runs on every rank of it, in batch order.
    Batch-parallel: the batch splits into ``len(groups)`` contiguous
    slices, one per group, and every round reads the pre-batch rows and
    adds its delta into the rank's ``acc``. Either way the draws are read
    in global sample order (masked samples draw too), and each rank takes
    its rows of every draw. Within a group, a synchronous round's vote is
    ``reduce`` of the ranks' partial votes (a list in, one total per rank
    out); a single rank needs none.
    """
    with span("tm.learn"):
        first = groups[0][0].ta
        xs = torch.as_tensor(xs).to(device=first.device, dtype=torch.uint8)
        batch = xs.shape[0]
        if batch % len(groups):
            raise ValueError(f"batch of {batch} does not split over "
                             f"{len(groups)} data ranks")
        per_group = batch // len(groups)
        lits = literals_from_input(xs)                    # (B, 2o)
        words = pack_bits(lits)                           # (B, W)
        on_device = {first.device: (lits, words)}
        for r in (r for g in groups for r in g):
            if r.ta.device not in on_device:
                on_device[r.ta.device] = (lits.to(r.ta.device),
                                          words.to(r.ta.device))
        ys = _host_list(ys, batch)
        valid = ([True] * batch if mask is None
                 else [bool(v) for v in _host_list(mask, batch)])
        with span("tm.draws"):
            negs, rounds = _batch_draws(cfg, draws, batch)
        for b in range(batch):
            with span("tm.draws"):
                d = rounds(b)
            if not valid[b]:
                continue
            rows = groups[b // per_group] if parallel else groups[0]
            y = ys[b]
            for cls, full, positive in ((y, d.target, True),
                                        (_negative_class(y, negs[b]), d.other,
                                         False)):
                with span("tm.round"):
                    _class_round(cfg, rows, cls, full, positive, b,
                                 on_device, parallel, reduce)


def _class_round(cfg: TMConfig, rows: list[ShardRows], cls: int,
                 full: FeedbackRands, positive: bool, b: int, on_device: dict,
                 parallel: bool, reduce) -> None:
    """One class round of sample ``b`` over the ranks ``rows``: every
    rank's vote half, the round's vote, then every rank's feedback half."""
    outs, votes = [], []
    for r in rows:
        with span("tm.round.vote"):
            c_out, v = _round_vote(cfg, r.ta[cls], on_device[r.ta.device][1][b],
                                   r.pol)
        outs.append(c_out)
        votes.append(v)
    sums = _vote_sums(rows, votes, cls, reduce)
    for r, c_out, vote_sum in zip(rows, outs, sums):
        lit = on_device[r.ta.device][0][b]
        with span("tm.round.feedback"):
            if not parallel:
                _round_feedback(cfg, r.ta[cls], lit, c_out, vote_sum,
                                r.rands(full), positive, r.pol,
                                clause_mask=r.clause_mask, out=r.ta[cls])
                continue
            new = _round_feedback(cfg, r.ta[cls], lit, c_out, vote_sum,
                                  r.rands(full), positive, r.pol,
                                  clause_mask=r.clause_mask, out=r.scratch)
            r.acc[cls].add_(new).sub_(r.ta[cls])


def _rows(cfg: TMConfig, ta: torch.Tensor, pol, clause_start, clause_mask,
          stale_votes, parallel: bool) -> ShardRows:
    if pol is None:
        if ta.shape[1] != cfg.n_clauses:
            raise ValueError(f"a state of {ta.shape[1]} clause rows is a "
                             f"shard of {cfg.n_clauses}: pass its pol=")
        pol = clause_polarity(cfg, ta.device)
    return ShardRows(
        ta=ta, pol=pol.to(device=ta.device, dtype=torch.int32),
        start=None if clause_start is None else int(clause_start),
        clause_mask=clause_mask, stale=stale_votes,
        acc=(torch.zeros(ta.shape, dtype=torch.int32, device=ta.device)
             if parallel else None))


def update_batch_sequential(cfg: TMConfig, state: TMState, xs, ys,
                            draws: "SampleDraws | torch.Generator", *,
                            mask=None, pol=None, clause_start=None,
                            clause_mask=None, stale_votes=None):
    """Faithful online learning over a batch: one sample after another, each
    seeing the state its predecessors left (the reference's ``lax.scan``).

    ``draws`` is the batch's ``SampleDraws`` (leading ``B`` axis) or a
    ``torch.Generator`` the samples draw from in turn. ``mask`` (B,) bool
    marks valid samples: masked rows consume their draws and apply no
    update — the padding contract for a fixed-shape trailing batch. Returns
    a new state; the input state is not modified.

    A clause shard's state takes its polarity slice ``pol``, its global
    first row ``clause_start`` (which rows of the full-size draws it reads)
    and ``clause_mask`` (its real rows; padding rows stay frozen). Each
    round then reads the shard's own vote. ``stale_votes`` (m,) int32 adds
    each class's stale remote term to it (asynchronous learning) and makes
    the return value ``(state, (vs, vc))``: the summed local votes and the
    round counts per class over the valid samples.
    """
    rows = _rows(cfg, state.ta_state.clone(), pol, clause_start, clause_mask,
                 stale_votes, parallel=False)
    learn_batch(cfg, [[rows]], xs, ys, draws, mask=mask)
    new = TMState(ta_state=rows.ta)
    return new if stale_votes is None else (new, rows.vote_stats)


def update_batch_parallel(cfg: TMConfig, state: TMState, xs, ys,
                          draws: "SampleDraws | torch.Generator", *,
                          mask=None, pol=None, clause_start=None,
                          clause_mask=None, stale_votes=None):
    """Batch-parallel update (beyond the paper): every sample's rounds see
    the same pre-batch state, and their deltas add before one clip to
    ``[1, 2N]``. The reference vmaps the samples into a ``(B, m, n, 2o)``
    delta; here the deltas accumulate one round at a time into one int32
    ``(m, n, 2o)`` buffer (4 GB fewer at ``tm_mnist``, B=32). ``draws``,
    ``mask`` and the shard keywords as in :func:`update_batch_sequential`.
    Returns a new state (with ``stale_votes``, ``(state, (vs, vc))``).
    """
    ta = state.ta_state
    rows = _rows(cfg, ta, pol, clause_start, clause_mask, stale_votes,
                 parallel=True)
    learn_batch(cfg, [[rows]], xs, ys, draws, mask=mask, parallel=True)
    new = TMState(ta_state=torch.clamp(ta.to(torch.int32) + rows.acc, 1,
                                       2 * cfg.n_states).to(cfg.state_dtype))
    return new if stale_votes is None else (new, rows.vote_stats)


def update_sample(cfg: TMConfig, state: TMState, x: torch.Tensor, y: int,
                  draws: SampleDraws, **shard):
    """One online update (the paper's per-sample learning): a positive round
    for the label's class, then a negative round for one other class
    (``draws.neg_raw`` shifted past ``y``). Returns a new state. The shard
    keywords are :func:`update_batch_sequential`'s."""
    x = torch.as_tensor(x)
    one = SampleDraws(torch.as_tensor(draws.neg_raw).reshape(1),
                      FeedbackRands(*(t[None] for t in draws.target)),
                      FeedbackRands(*(t[None] for t in draws.other)))
    return update_batch_sequential(cfg, state, x.reshape(1, -1), [int(y)],
                                   one, **shard)
