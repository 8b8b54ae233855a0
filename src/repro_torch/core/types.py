"""Core TM configuration and state containers (PyTorch port).

Layout conventions (paper §2-§3), the same as ``repro.core.types``:
  * ``o``        — number of input features; literal k < o is x_k, literal
                   k >= o is ¬x_{k-o}; total ``2o`` literals.
  * ``ta_state`` — int16 tensor ``(m, n, 2o)`` of Tsetlin Automaton states in
                   ``[1, 2N]``; action = include iff state > N.
  * clause polarity — clauses ``[0, n/2)`` are positive, ``[n/2, n)`` negative
                   (paper Eq. 2/3).

Device rule: entry points take ``device=`` (default ``"cuda"``) and pass it
through :func:`resolve_device`, which raises when CUDA is missing instead of
quietly running on the CPU. Lower-level functions take the device of the
tensors they are given.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

# TMConfig.backend's only value. The kernel is chosen by the device of the
# tensors, so there is nothing left to select; the field stays so that
# configs and checkpoint fingerprints carry over from the reference package.
_AUTO_BACKEND = "auto"


def resolve_device(device) -> torch.device:
    """``device`` → ``torch.device``; raises if it names CUDA and there is none.

    The port never falls back to the CPU on its own: a caller who wants the
    CPU says ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but CUDA is not available in this "
            "process; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}; 'cuda' or 'cpu'")
    return dev


@dataclasses.dataclass(frozen=True)
class TMConfig:
    """Hyper-parameters of a (multiclass) Tsetlin Machine."""

    n_classes: int
    n_clauses: int          # clauses per class (half positive / half negative)
    n_features: int         # o
    n_states: int = 127     # N; state space is [1, 2N]
    s: float = 3.9          # specificity (reward/penalty split)
    threshold: int = 15     # T (vote clamp / annealing parameter)
    boost_true_positive: bool = False
    # Paper Eq. (4) counts never-falsified (incl. empty) clauses as true.
    # Classic TM inference outputs 0 for empty clauses. 1 == paper semantics.
    empty_clause_output: int = 1
    state_dtype: torch.dtype = torch.int16
    # Engine-cache capacities: index_capacity — per-literal inclusion-list
    # rows (ClauseIndex), None → worst case n_clauses; clause_capacity —
    # per-clause included-literal rows, None → worst case 2o.
    index_capacity: int | None = None
    clause_capacity: int | None = None
    # Kept for config/fingerprint compatibility with the reference; only
    # 'auto' exists.
    backend: str = _AUTO_BACKEND

    def __post_init__(self):
        if self.n_clauses % 2:
            raise ValueError("n_clauses must be even (half per polarity)")
        if self.backend != _AUTO_BACKEND:
            raise ValueError(
                f"kernel backend {self.backend!r} is not selectable in the "
                "PyTorch port: the device of the tensors picks the kernel "
                "(CUDA kernel on a CUDA tensor, plain PyTorch on a CPU "
                f"tensor); use backend={_AUTO_BACKEND!r}")
        if self.empty_clause_output not in (0, 1):
            raise ValueError("empty_clause_output must be 0 or 1")
        if self.index_capacity is not None and self.index_capacity < 1:
            raise ValueError("index_capacity must be >= 1")
        if self.clause_capacity is not None and self.clause_capacity < 1:
            raise ValueError("clause_capacity must be >= 1")

    @property
    def n_literals(self) -> int:
        """2o — total literal count (positive + negated features)."""
        return 2 * self.n_features

    @property
    def half_clauses(self) -> int:
        """n/2 — clauses per polarity."""
        return self.n_clauses // 2

    @property
    def resolved_index_capacity(self) -> int:
        """Inclusion-list capacity (``index_capacity`` or the worst case)."""
        return self.index_capacity if self.index_capacity is not None else self.n_clauses

    @property
    def resolved_clause_capacity(self) -> int:
        """Per-clause literal capacity (``clause_capacity`` or worst case)."""
        return (self.clause_capacity if self.clause_capacity is not None
                else self.n_literals)


class TMState(NamedTuple):
    """Learnable state of a TM."""

    ta_state: torch.Tensor  # (m, n, 2o) int16 in [1, 2N]

    @property
    def n_classes(self) -> int:
        """m — classes (leading ``ta_state`` axis)."""
        return self.ta_state.shape[0]

    @property
    def n_clauses(self) -> int:
        """n — clause rows."""
        return self.ta_state.shape[1]

    @property
    def n_literals(self) -> int:
        """2o — literals (trailing ``ta_state`` axis)."""
        return self.ta_state.shape[2]


class VoteAccumulator(NamedTuple):
    """Double-buffered per-class vote sums of asynchronous sharded training
    (``Topology(async_votes=K)``; reference ``repro.core.types``).

      * ``local``    — (R, m) int32: each vote rank's latest local partial
                       vote per class (the batch mean of the rounds it ran;
                       a class untouched in a step keeps its value).
      * ``stale``    — (R, m) int32: the read buffer, each rank's estimate
                       of the other ranks' votes (the last refresh's total
                       minus its own ``local``). A round reads
                       ``live local vote + stale`` and reduces nothing.
      * ``overflow`` — (R,) int32: cache-sync events dropped on the rank
                       since the last refresh, drained by the refresh.

    R counts the vote ranks. A sharded bundle keeps one ``R = 1`` row per
    (data, clause) rank on the rank's device; its ``vote_acc`` view stacks
    them data-major, clause-minor. Rebuildable state: checkpoints never
    hold it, and a restore starts from zeros.
    """

    local: torch.Tensor
    stale: torch.Tensor
    overflow: torch.Tensor


def init_tm(cfg: TMConfig, device) -> TMState:
    """All TAs start just on the *exclude* side of the boundary (state N),
    so every inclusion list starts empty."""
    ta = torch.full((cfg.n_classes, cfg.n_clauses, cfg.n_literals),
                    cfg.n_states, dtype=cfg.state_dtype,
                    device=torch.device(device))
    return TMState(ta_state=ta)


def literals_from_input(x: torch.Tensor) -> torch.Tensor:
    """(…, o) {0,1} input → (…, 2o) uint8 literal truth values [x, ¬x]."""
    x = x.to(torch.uint8)
    return torch.cat([x, 1 - x], dim=-1)


def include_mask(cfg: TMConfig, state: TMState) -> torch.Tensor:
    """(m, n, 2o) bool — TA action is *include*."""
    return state.ta_state > cfg.n_states


@functools.lru_cache(maxsize=64)
def _polarity(n_clauses: int, half: int, device: torch.device) -> torch.Tensor:
    pol = torch.full((n_clauses,), -1, dtype=torch.int32, device=device)
    pol[:half] = 1
    return pol


def clause_polarity(cfg: TMConfig, device) -> torch.Tensor:
    """(n,) int32 — +1 for positive clauses, -1 for negative.

    Cached per (shape, device) so the serving path does not rebuild it per
    batch; the returned tensor is shared and must not be written to.
    """
    return _polarity(cfg.n_clauses, cfg.half_clauses, torch.device(device))
