"""Evaluation-engine registry — port of ``repro.core.engines``.

One TM admits several semantically identical evaluation strategies with
very different work profiles (exhaustive vs the falsification index).

  * ``EvalEngine`` — ``prepare(cfg, state) -> cache`` builds the engine's
    cache (packed include words, ``ClauseIndex``); ``scores(cfg, cache, x)``
    evaluates from the cache alone.
  * ``register_engine`` / ``get_engine`` / ``registered_engines`` /
    ``cache_provider`` — the registry. ``dense``, ``bitpack`` and
    ``indexed`` register at import.

The packed and indexed engines score through the kernel registry
(``kernels/backend.py``), where the tensors' device picks the CUDA kernel
or the plain body. Incremental ``update_cache`` (training), the ``compact``
engine and the ``bitpack_xla`` alias come in later slices.

All engines implement the paper's Eq. 4 convention (empty clauses count as
true); with ``cfg.empty_clause_output == 0`` only ``dense`` follows the
classic convention.
"""
from __future__ import annotations

import torch

from repro_torch.core import indexing, tm
from repro_torch.core.bitpack import pack_bits, packed_literals
from repro_torch.core.types import (
    TMConfig, TMState, clause_polarity, include_mask, literals_from_input)
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

    def update_cache(self, cfg: TMConfig, cache, state: TMState, events):
        """Absorb TA boundary crossings (training)."""
        raise NotImplementedError(
            "incremental cache maintenance comes with training, in slice 2 "
            "of the PyTorch port")


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


class BitpackEngine(EvalEngine):
    """32×-packed include words scored by the ``clause_votes`` primitive
    (CUDA kernel ``clause_votes_packed`` on the card)."""

    name = "bitpack"
    cache_key = "bitpack"

    def prepare(self, cfg: TMConfig, state: TMState) -> torch.Tensor:
        return pack_bits(include_mask(cfg, state))

    def scores(self, cfg, cache, x):
        return kbackend.resolve("clause_votes")(
            cache, packed_literals(x), clause_polarity(cfg, cache.device))


class IndexedEngine(EvalEngine):
    """The paper's falsification index, scored by the ``indexed_votes``
    primitive (CUDA kernel ``indexed_votes`` on the card) over the position
    matrix's membership mask."""

    name = "indexed"

    def prepare(self, cfg: TMConfig, state: TMState) -> indexing.ClauseIndex:
        return indexing.build_index(cfg, state, cfg.resolved_index_capacity)

    def scores(self, cfg, cache, x):
        return kbackend.resolve("indexed_votes")(
            cache.pos, literals_from_input(x),
            clause_polarity(cfg, cache.pos.device))


register_engine(DenseEngine())
register_engine(BitpackEngine())
register_engine(IndexedEngine())
