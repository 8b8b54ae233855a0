"""Tsetlin Machine forward pass and learning (paper §2) — port of
``repro.core.tm``.

Forward: ``dense_clause_outputs``, ``clause_votes``, ``scores``,
``predict``, ``accuracy``. Learning: Type I / Type II feedback, one class
round at a time (``_class_round``: clause outputs through the
``clause_outputs`` primitive, one clamped vote, then the ``ta_update``
primitive), per sample (``update_sample``) and per batch, sequentially as
the paper learns (``update_batch_sequential``) or batch-parallel
(``update_batch_parallel``).

Randomness comes in as explicit uniforms (``FeedbackRands``,
``SampleDraws``), like the reference's, so a test can hand both packages
the same draws. In production the draws come from a ``torch.Generator`` in
the order :func:`draw_sample_draws` documents; ``jax.random`` cannot be
replayed in PyTorch, so the two packages agree under injected draws only.
"""
from __future__ import annotations

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


def _round_clause_outputs(cfg: TMConfig, ta_row: torch.Tensor,
                          lit_words: torch.Tensor) -> torch.Tensor:
    """(n,) int8 clause outputs of one class row (learning semantics: an
    empty clause gives 1) through the ``clause_outputs`` primitive.

    The row's include mask is packed on every round, as the reference's
    kernel route does (``pack_bits`` makes an int64 ``(n, W, 32)``
    temporary). ``lit_words`` is the sample's ``(1, W)`` packed literals.
    """
    inc_words = pack_bits(ta_row > cfg.n_states)[None]            # (1, n, W)
    return kbackend.resolve("clause_outputs")(inc_words, lit_words)[0, 0]


def _reciprocal_2t(t: float) -> float:
    """float32 ``1 / (2t)``. XLA folds the reference's division by the
    constant ``2t`` into a product with this reciprocal (float32 division of
    float32 values), and ``p`` must match it bit for bit."""
    return float(np.float32(1.0) / np.float32(2.0 * t))


def _class_round(cfg: TMConfig, ta_row: torch.Tensor, lit: torch.Tensor,
                 rands: FeedbackRands, positive_round: bool, *,
                 lit_words: torch.Tensor | None = None,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """One feedback round for one class; returns the updated (n, 2o) row.

    ``lit`` is the sample's (2o,) uint8 literals (``lit_words`` its packed
    form, computed here when absent). The clause outputs give one vote,
    clamped to ``[-T, T]`` in float32 as the reference's Python-float clip
    makes it; ``p = (T ∓ vote)/(2T)`` gates each clause against its uniform.
    In the target round positive clauses take Type I feedback and negative
    ones Type II; the other round swaps them. ``out`` receives the new row
    (it may be ``ta_row`` itself, for an in-place round).
    """
    if lit_words is None:
        lit_words = pack_bits(lit[None])
    clause_out = _round_clause_outputs(cfg, ta_row, lit_words)
    pol = clause_polarity(cfg, ta_row.device)
    t = float(cfg.threshold)
    vote_sum = (clause_out.to(torch.int32) * pol).sum(dtype=torch.int32)
    votes = vote_sum.to(torch.float32).clamp(-t, t)
    p = ((t - votes) if positive_round else (t + votes)) * _reciprocal_2t(t)
    active = rands.clause_gate < p                                # (n,)
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


def _sample_rounds_(cfg: TMConfig, ta: torch.Tensor, lit: torch.Tensor,
                    lit_words: torch.Tensor, y: int, neg: int,
                    draws: SampleDraws) -> None:
    """The target round on row ``y``, then the negative round on row
    ``neg``, each updating its row of ``ta`` in place."""
    _class_round(cfg, ta[y], lit, draws.target, True, lit_words=lit_words,
                 out=ta[y])
    _class_round(cfg, ta[neg], lit, draws.other, False, lit_words=lit_words,
                 out=ta[neg])


def update_sample(cfg: TMConfig, state: TMState, x: torch.Tensor, y: int,
                  draws: SampleDraws) -> TMState:
    """One online update (the paper's per-sample learning): a positive round
    for the label's class, then a negative round for one other class
    (``draws.neg_raw`` shifted past ``y``). Returns a new state."""
    ta = state.ta_state.clone()
    y = int(y)
    lit = literals_from_input(x)
    _sample_rounds_(cfg, ta, lit, pack_bits(lit[None]), y,
                    _negative_class(y, int(draws.neg_raw)), draws)
    return TMState(ta_state=ta)


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


def _prepare_batch(cfg: TMConfig, state: TMState, xs, ys, mask, draws):
    dev = state.ta_state.device
    xs = torch.as_tensor(xs).to(device=dev, dtype=torch.uint8)
    batch = xs.shape[0]
    lits = literals_from_input(xs)                     # (B, 2o)
    words = pack_bits(lits)                            # (B, W)
    ys = _host_list(ys, batch)
    valid = [True] * batch if mask is None else [bool(v) for v in
                                                 _host_list(mask, batch)]
    negs, rounds = _batch_draws(cfg, draws, batch)
    return batch, lits, words, ys, valid, negs, rounds


def update_batch_sequential(cfg: TMConfig, state: TMState, xs, ys,
                            draws: "SampleDraws | torch.Generator", *,
                            mask=None) -> TMState:
    """Faithful online learning over a batch: one sample after another, each
    seeing the state its predecessors left (the reference's ``lax.scan``).

    ``draws`` is the batch's ``SampleDraws`` (leading ``B`` axis) or a
    ``torch.Generator`` the samples draw from in turn. ``mask`` (B,) bool
    marks valid samples: masked rows consume their draws and apply no
    update — the padding contract for a fixed-shape trailing batch. Returns
    a new state; the input state is not modified.
    """
    ta = state.ta_state.clone()
    batch, lits, words, ys, valid, negs, rounds = _prepare_batch(
        cfg, state, xs, ys, mask, draws)
    for b in range(batch):
        d = rounds(b)
        if valid[b]:
            _sample_rounds_(cfg, ta, lits[b], words[b:b + 1], ys[b],
                            _negative_class(ys[b], negs[b]), d)
    return TMState(ta_state=ta)


def update_batch_parallel(cfg: TMConfig, state: TMState, xs, ys,
                          draws: "SampleDraws | torch.Generator", *,
                          mask=None) -> TMState:
    """Batch-parallel update (beyond the paper): every sample's rounds see
    the same pre-batch state, and their deltas add before one clip to
    ``[1, 2N]``. The reference vmaps the samples into a ``(B, m, n, 2o)``
    delta; here the deltas accumulate one sample at a time into one int32
    ``(m, n, 2o)`` buffer (4 GB fewer at ``tm_mnist``, B=32). ``draws`` and
    ``mask`` as in :func:`update_batch_sequential`. Returns a new state.
    """
    ta = state.ta_state
    acc = torch.zeros(ta.shape, dtype=torch.int32, device=ta.device)
    scratch = torch.empty(ta.shape[1:], dtype=ta.dtype, device=ta.device)
    batch, lits, words, ys, valid, negs, rounds = _prepare_batch(
        cfg, state, xs, ys, mask, draws)
    for b in range(batch):
        d = rounds(b)
        if not valid[b]:
            continue
        y = ys[b]
        for cls, rands, positive in ((y, d.target, True),
                                     (_negative_class(y, negs[b]), d.other,
                                      False)):
            _class_round(cfg, ta[cls], lits[b], rands, positive,
                         lit_words=words[b:b + 1], out=scratch)
            acc[cls].add_(scratch).sub_(ta[cls])
    new = torch.clamp(ta.to(torch.int32) + acc, 1, 2 * cfg.n_states)
    return TMState(ta_state=new.to(cfg.state_dtype))
