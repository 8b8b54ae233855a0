"""Plain reference of the Tsetlin Machine (paper §2, Eq. 4; Granmo 2018
feedback), written out again from the paper in plain PyTorch.

It imports nothing of the program under test and takes nothing the
program made: it reads the TA states, rows and labels the benchmark
generated, and draws its own uniforms from the machine's seed in the
frozen order below.

* :func:`scores` — dense Eq. 4: a clause is true iff none of its included
  literals is false (an empty clause is true); a class's score is its
  positive clauses' true count minus its negative clauses'. The count of
  included-and-false literals per clause is one float32 product of 0/1
  operands with TF32 off: exact below 2**24.
* :class:`Draws` — the draw order of the program's documented stream
  (``draw_sample_draws``): per step the batch's ``B`` raw negative-class
  draws, uniform on ``[0, m-1)``; then per sample, in batch order, the
  target round's and the negative round's (clause gate ``(n,)``, Type I
  ``(n, 2o)``) float32 uniforms. A change to that stream is a change to
  the benchmark.
* :func:`learn_step` — sequential online learning over one batch: each
  sample a positive round on its label's class and a negative round on
  ``neg_raw`` shifted past the label, each round the clamped vote,
  ``p = (T ∓ v)/(2T)`` against the gate, Type I / Type II per the clause's
  polarity, clipped to ``[1, 2N]``.

``control`` arguments compute the same in the precision below the one the
configuration states: TA states held in int8 (int16 is stated), uniforms
in bfloat16 (float32 is stated).
"""
from __future__ import annotations

import numpy as np
import torch


def literals(x: torch.Tensor) -> torch.Tensor:
    """(B, o) {0,1} → (B, 2o) uint8 [x, ¬x]."""
    x = x.to(torch.uint8)
    return torch.cat([x, 1 - x], dim=-1)


def polarity(n: int, device) -> torch.Tensor:
    """(n,) int32: +1 for clauses [0, n/2), -1 for the rest."""
    pol = torch.full((n,), -1, dtype=torch.int32, device=device)
    pol[: n // 2] = 1
    return pol


def include_of(ta: torch.Tensor, n_states: int, *,
               control: bool = False) -> torch.Tensor:
    """(m, n, 2o) bool: the TA's action is include (state > N). The control
    holds the states in int8 first, which wraps every state past 127."""
    if control:
        ta = ta.to(torch.int8)
    return ta > n_states


def scores(include: torch.Tensor, x: torch.Tensor,
           block: int = 2048) -> torch.Tensor:
    """(m, n, 2o) include mask + (B, o) rows → (B, m) int32 Eq. 4 scores,
    on the mask's device, in blocks of rows."""
    m, n, two_o = include.shape
    dev = include.device
    inc = include.reshape(m * n, two_o).to(torch.float32)
    pol = polarity(n, dev)
    out = []
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for start in range(0, x.shape[0], block):
            xb = x[start:start + block].to(dev)
            false_lit = (literals(xb) == 0).to(torch.float32)
            counts = false_lit @ inc.T                          # (b, m·n)
            true = (counts < 0.5).reshape(-1, m, n).to(torch.int32)
            out.append((true * pol).sum(-1, dtype=torch.int32))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return torch.cat(out) if out else torch.zeros((0, m), dtype=torch.int32)


class Draws:
    """The uniforms of a machine seeded with ``seed`` on ``device``, in the
    frozen order (module docstring)."""

    def __init__(self, m: int, n: int, two_o: int, seed: int, device, *,
                 generator: torch.Generator | None = None):
        self.m, self.n, self.two_o = m, n, two_o
        self.device = torch.device(device)
        self.gen = (torch.Generator(device=self.device).manual_seed(seed)
                    if generator is None else generator)

    def negatives(self, batch: int) -> list[int]:
        """A batch's raw negative-class draws."""
        return torch.randint(0, self.m - 1, (batch,), generator=self.gen,
                             device=self.device).tolist()

    def skip(self, steps: int, batch: int) -> None:
        """Draw and drop ``steps`` whole steps of ``batch`` samples, call for
        call as they are drawn, so that the next draw is the one after them."""
        neg = torch.empty((batch,), dtype=torch.int64, device=self.device)
        gate = torch.empty((self.n,), device=self.device)
        type_i = torch.empty((self.n, self.two_o), device=self.device)
        for _ in range(steps):
            torch.randint(0, self.m - 1, (batch,), generator=self.gen, out=neg)
            for _ in range(2 * batch):
                torch.rand((self.n,), generator=self.gen, out=gate)
                torch.rand((self.n, self.two_o), generator=self.gen, out=type_i)

    def round(self) -> tuple[torch.Tensor, torch.Tensor]:
        """One class round's (gate (n,), Type I (n, 2o)) uniforms."""
        gate = torch.rand((self.n,), generator=self.gen, device=self.device)
        type_i = torch.rand((self.n, self.two_o), generator=self.gen,
                            device=self.device)
        return gate, type_i


def _f32(x: float) -> float:
    return float(np.float32(x))


def _round(row: torch.Tensor, lit: torch.Tensor, gate: torch.Tensor,
           type_i_u: torch.Tensor, positive: bool, pol: torch.Tensor,
           hp: dict, stats: list | None) -> None:
    """One class round on the (n, 2o) int16 ``row``, in place."""
    n_states = hp["n_states"]
    include = row > n_states
    false_lit = lit == 0
    clause_true = ~(include & false_lit[None, :]).any(-1)            # (n,)
    vote = (clause_true.to(torch.int32) * pol).sum(dtype=torch.int32)
    t = float(hp["threshold"])
    v = vote.to(torch.float32).clamp(-t, t)
    p = ((t - v) if positive else (t + v)) * _f32(np.float32(1.0) / np.float32(2.0 * t))
    active = gate < p
    type_i = (pol > 0) if positive else (pol <= 0)
    inv_s = _f32(1.0 / hp["s"])
    p_reward = 1.0 if hp["boost_true_positive"] else _f32(1.0 - 1.0 / hp["s"])
    c1 = clause_true[:, None]
    l1 = (lit == 1)[None, :]
    reward = c1 & l1 & (type_i_u < p_reward)
    penalty = (~c1 | ~l1) & (type_i_u < inv_s)
    d1 = reward.to(torch.int16) - penalty.to(torch.int16)
    d2 = (c1 & ~l1 & ~include).to(torch.int16)
    t1 = (active & type_i)[:, None]
    t2 = (active & ~type_i)[:, None]
    delta = torch.where(t1, d1, torch.where(t2, d2, torch.zeros_like(d1)))
    new = torch.clamp(row + delta, 1, 2 * n_states).to(torch.int16)
    if stats is not None:
        stats.append(torch.stack([
            (active & type_i).sum(),                     # Type I rows
            (active & (type_i | clause_true)).sum(),     # rows whose states it reads
            (new != row).sum()]))                        # states written
    row.copy_(new)


def learn_step(ta: torch.Tensor, x: torch.Tensor, y: list[int], draws: Draws,
               hp: dict, *, control: bool = False,
               stats: list | None = None) -> None:
    """One sequential step over the batch ``x`` (B, o), labels ``y``, on
    the (m, n, 2o) int16 states ``ta`` in place. ``control`` holds the
    uniforms in bfloat16. ``stats`` (a list) receives per round a tensor
    (Type I rows, rows read, states changed)."""
    m, n, _ = ta.shape
    pol = polarity(n, ta.device)
    lits = literals(x.to(ta.device))
    negs = draws.negatives(len(y))
    for b, label in enumerate(y):
        target, other = draws.round(), draws.round()
        neg = negs[b] + 1 if negs[b] >= label else negs[b]
        for cls, (gate, u), positive in ((label, target, True),
                                         (neg, other, False)):
            if control:
                gate = gate.to(torch.bfloat16).to(torch.float32)
                u = u.to(torch.bfloat16).to(torch.float32)
            _round(ta[cls], lits[b], gate, u, positive, pol, hp, stats)
