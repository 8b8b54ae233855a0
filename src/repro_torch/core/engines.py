"""Evaluation-engine registry — port of ``repro.core.engines``.

One TM admits several semantically identical evaluation strategies with
very different work profiles (exhaustive vs the falsification index).

  * ``EvalEngine`` — ``prepare(cfg, state) -> cache`` builds the engine's
    cache (packed include words, ``ClauseIndex``); ``scores(cfg, cache, x)``
    evaluates from the cache alone; ``update_cache`` absorbs the include /
    exclude events of a training step.
  * ``register_engine`` / ``get_engine`` / ``registered_engines`` /
    ``cache_provider`` — the registry. ``dense``, ``bitpack``, ``compact``
    and ``indexed`` register at import.

The packed and indexed engines score through the kernel registry
(``kernels/backend.py``), where the tensors' device picks the CUDA kernel
or the plain body. The ``compact`` engine is PyTorch tensor code on both
devices, as it is XLA code in the reference (no Pallas body). The
reference's ``bitpack_xla`` alias is not registered: it pins the plain
body regardless of the device, and the port keeps plain bodies off card
paths.

Shard contract (``core/distributed.py``): ``shard_prepare`` builds a clause
shard's cache from the shard's state slice, and ``partial_scores`` gives the
shard's partial votes through the same primitives with the shard's
polarity slice (sign 0 on padding rows); the partials of all clause shards
add up to the scores. The reference's ``cache_pspec`` (how a cache's arrays
lay out over the mesh) has no PyTorch counterpart: a sharded bundle keeps
one whole cache per rank, on the rank's device (``distributed.py``).

All engines implement the paper's Eq. 4 convention (empty clauses count as
true); with ``cfg.empty_clause_output == 0`` only ``dense`` follows the
classic convention.
"""
from __future__ import annotations

import torch

from repro_torch.core import indexing, tm
from repro_torch.core.bitpack import WORD, pack_bits, packed_literals
from repro_torch.core.types import (
    TMConfig, TMState, clause_polarity, include_mask)
from repro_torch.kernels import backend as kbackend


class EvalEngine:
    """Base class for evaluation engines. Subclass + ``register_engine``.

    ``name``        — registry key, the user-facing engine string.
    ``cache_key``   — storage key inside a ``TMBundle``; engines with the same
                      ``cache_key`` must build identical caches.
    ``needs_cache`` — False when ``prepare`` returns state the bundle
                      already carries; such engines never store a cache.
    """

    name: str = ""
    cache_key: str = ""
    needs_cache: bool = True

    def prepare(self, cfg: TMConfig, state: TMState):
        """Build this engine's cache from scratch."""
        raise NotImplementedError

    def scores(self, cfg: TMConfig, cache, x: torch.Tensor) -> torch.Tensor:
        """(B, o) inputs → (B, m) int32 class scores from the cache alone."""
        raise NotImplementedError

    def update_cache(self, cfg: TMConfig, cache, state: TMState,
                     events: indexing.Event):
        """Absorb TA boundary crossings; the default rebuilds.

        ``state`` is the post-update TA state and ``events`` the include-mask
        diff that produced it (``indexing.events_from_transition``); the
        cache must have been in sync with the pre-update state.
        """
        del events
        return self.prepare(cfg, state)

    def shard_prepare(self, cfg: TMConfig, state: TMState, n_shards: int):
        """Cache of one clause shard from its state slice. Default:
        ``prepare``, right wherever a cache's arrays carry the clause axis
        (the indexed engine splits its list capacity instead)."""
        del n_shards
        return self.prepare(cfg, state)

    def partial_scores(self, cfg: TMConfig, cache, x: torch.Tensor,
                       pol: torch.Tensor) -> torch.Tensor:
        """(B, m) int32 partial votes over one shard's clauses; ``pol`` is
        the shard's (n_local,) polarity slice, 0 on padding rows. The
        partials of all clause shards add up to ``scores``."""
        raise NotImplementedError(
            f"engine {self.name!r} does not implement partial_scores")


def _partial_votes(clause_out: torch.Tensor, pol: torch.Tensor) -> torch.Tensor:
    """(B, m, n_local) clause outputs × (n_local,) polarity → (B, m) int32."""
    return (clause_out.to(torch.int32) * pol.to(torch.int32)).sum(
        -1, dtype=torch.int32)


_REGISTRY: dict[str, EvalEngine] = {}
_CACHE_PROVIDERS: dict[str, EvalEngine] = {}


def register_engine(engine: EvalEngine) -> EvalEngine:
    """Add an engine instance to the registry (idempotent per name)."""
    if not engine.name:
        raise ValueError("engine must set a non-empty .name")
    if not engine.cache_key:
        engine.cache_key = engine.name
    _REGISTRY[engine.name] = engine
    # first registrant for a cache_key owns prepare for it
    _CACHE_PROVIDERS.setdefault(engine.cache_key, engine)
    return engine


def get_engine(name: str) -> EvalEngine:
    """Look up a registered engine by name (KeyError lists what exists)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown engine {name!r}; registered: {registered_engines()}"
        ) from None


def registered_engines() -> tuple[str, ...]:
    """Registered engine names, registration order."""
    return tuple(_REGISTRY)


def cache_provider(cache_key: str) -> EvalEngine:
    """The engine that owns prepare for a given cache slot."""
    return _CACHE_PROVIDERS[cache_key]


class DenseEngine(EvalEngine):
    """Exhaustive eval straight off the TA state; the cache *is* the state,
    so none is stored (``needs_cache=False``)."""

    name = "dense"
    needs_cache = False

    def prepare(self, cfg: TMConfig, state: TMState) -> TMState:
        return state

    def scores(self, cfg: TMConfig, cache: TMState, x: torch.Tensor) -> torch.Tensor:
        return tm.scores(cfg, cache, x)

    def update_cache(self, cfg, cache, state, events):
        del events
        return state  # the new state is the new cache

    def partial_scores(self, cfg, cache, x, pol):
        return _partial_votes(tm.dense_clause_outputs(cfg, cache, x), pol)


def packed_include_apply_events(words: torch.Tensor,
                                events: indexing.Event) -> torch.Tensor:
    """Flip the include bits a masked event buffer names; returns new words.

    Events from ``events_from_transition`` touch distinct (i, j, k) cells
    and always cross the boundary in their stated direction, so each one
    flips its bit: XOR. The reference adds ``0xFFFFFFFF·mask`` in uint32
    instead, which int32 words cannot do exactly at bit 31. The flips of
    one word are distinct powers of two, so they gather into one int64 mask
    per word by an exact sum (in any order), wrapped to the int32 word.
    """
    m, n, w = words.shape
    v = events.valid.to(torch.bool)
    lit = events.literal.long()
    word = ((events.cls.long() * n + events.clause.long()) * w
            + torch.div(lit, WORD, rounding_mode="floor"))
    bit = torch.where(v, torch.ones_like(lit) << (lit % WORD), 0)
    flips = torch.zeros(words.numel(), dtype=torch.int64, device=words.device)
    flips.index_put_((torch.where(v, word, 0),), bit, accumulate=True)
    flips = torch.where(flips >= 2**31, flips - 2**32, flips).to(torch.int32)
    return words ^ flips.reshape(words.shape)


class BitpackEngine(EvalEngine):
    """32×-packed include words scored by the ``clause_votes`` primitive
    (CUDA kernel ``clause_votes_packed`` on the card)."""

    name = "bitpack"
    cache_key = "bitpack"

    def prepare(self, cfg: TMConfig, state: TMState) -> torch.Tensor:
        return pack_bits(include_mask(cfg, state))

    def update_cache(self, cfg, cache, state, events):
        del state
        return packed_include_apply_events(cache, events)

    def scores(self, cfg, cache, x):
        return self.partial_scores(cfg, cache, x,
                                   clause_polarity(cfg, cache.device))

    def partial_scores(self, cfg, cache, x, pol):
        return kbackend.resolve("clause_votes")(cache, packed_literals(x), pol)


class IndexedEngine(EvalEngine):
    """The paper's falsification index, scored by the ``indexed_votes``
    primitive (CUDA kernel ``indexed_votes`` on the card): a walk of the
    false literals' inclusion lists."""

    name = "indexed"

    def prepare(self, cfg: TMConfig, state: TMState) -> indexing.ClauseIndex:
        return indexing.build_index(cfg, state, cfg.resolved_index_capacity)

    def update_cache(self, cfg, cache, state, events):
        del state
        return indexing.index_update(cache, events)

    def scores(self, cfg, cache, x):
        return indexing.indexed_scores(cfg, cache, x)

    def shard_prepare(self, cfg, state, n_shards):
        cap = indexing.shard_capacity(cfg.resolved_index_capacity, n_shards)
        return indexing.build_index(cfg, state, cap)

    def partial_scores(self, cfg, cache, x, pol):
        # -Σ_{falsified} pol: a shard's partial is not its own vote sum
        # (that would add Σ pol_local), but the partials of all shards add
        # up to the scores because the full polarity sums to 0
        return indexing.indexed_partial_scores(cache, x, pol)


class CompactEngine(EvalEngine):
    """Clause-compact transpose layout (``indexing.CompactClauses``): each
    clause's included literal ids, evaluated by one gather. ℓ_max is
    static from the config (``cfg.resolved_clause_capacity``), not a
    data-dependent host sync."""

    name = "compact"

    def prepare(self, cfg: TMConfig, state: TMState) -> indexing.CompactClauses:
        return indexing.compact(cfg, state, cfg.resolved_clause_capacity)

    def scores(self, cfg, cache, x):
        return indexing.compact_scores(cfg, cache, x)

    def update_cache(self, cfg, cache, state, events):
        del state
        return indexing.compact_apply_events(cache, events)

    def partial_scores(self, cfg, cache, x, pol):
        return _partial_votes(indexing.compact_eval(cfg, cache, x), pol)


register_engine(DenseEngine())
register_engine(BitpackEngine())
register_engine(CompactEngine())
register_engine(IndexedEngine())
