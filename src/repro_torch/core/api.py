"""TM bundle API — port of ``repro.core.api``.

``TMBundle`` bundles the ``TMConfig`` with the TA state and the
per-``cache_key`` engine caches: one value carries everything needed to
train and to serve through any registered engine. ``train_step`` runs the
dense Type I/II feedback over a batch, diffs the include masks into an
event buffer, and lets every cache absorb the events (``sync_caches``).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Iterable

import torch

from repro_torch.core import indexing, tm
from repro_torch.core.engines import cache_provider, get_engine, registered_engines
from repro_torch.core.types import (
    TMConfig, TMState, VoteAccumulator, include_mask, init_tm, resolve_device)
from repro_torch.spans import span

DEFAULT_ENGINE = "indexed"


@dataclasses.dataclass(frozen=True)
class TMBundle:
    """Config + TA state + engine caches.

    ``event_overflow`` counts the cache-sync events dropped by the
    fixed-size buffer since the bundle was prepared (a 0-d int32 tensor on
    the bundle's device): non-zero means the caches are stale, and
    ``max_events`` was too small for some step. ``vote_acc`` is the
    stale-vote accumulator of asynchronous sharded training (one rank's row
    in a sharded bundle, ``core/distributed.py``); None otherwise. It is
    carried through ``sync_caches`` / ``train_step`` and never checkpointed.
    """

    cfg: TMConfig
    state: TMState
    caches: dict[str, Any]
    event_overflow: torch.Tensor | None = None
    vote_acc: VoteAccumulator | None = None

    @property
    def index(self) -> indexing.ClauseIndex:
        """The paper's clause index (present when the indexed engine is on)."""
        return self.caches["indexed"]


def cache_keys_for(engine_names: Iterable[str] | None = None) -> tuple[str, ...]:
    """Distinct cache slots the named engines need (``None`` → all registered).

    Cache-less engines (``needs_cache=False``) read ``bundle.state`` directly
    and contribute no slot.
    """
    names = (tuple(engine_names) if engine_names is not None
             else registered_engines())
    keys: dict[str, None] = {}
    for name in names:
        eng = get_engine(name)
        if eng.needs_cache:
            keys.setdefault(eng.cache_key, None)
    return tuple(keys)


def init_bundle(cfg: TMConfig, *, engines: Iterable[str] | None = None,
                state: TMState | None = None, device="cuda") -> TMBundle:
    """Bundle with caches prepared for the requested engines.

    ``state`` moves to ``device``; without one, a fresh all-exclude state is
    made there. ``engines=None`` prepares every registered engine's cache.
    """
    dev = resolve_device(device)
    names = tuple(engines) if engines is not None else registered_engines()
    if state is None:
        state = init_tm(cfg, dev)
    else:
        state = TMState(ta_state=state.ta_state.to(dev, cfg.state_dtype))
    caches = {key: cache_provider(key).prepare(cfg, state)
              for key in cache_keys_for(names)}
    return TMBundle(cfg=cfg, state=state, caches=caches,
                    event_overflow=torch.zeros((), dtype=torch.int32, device=dev))


# cache slots whose on-the-fly rebuild was already warned about once
_REBUILD_WARNED: set[str] = set()


def engine_cache(bundle: TMBundle, engine: str):
    """The cache ``engine`` scores from: the bundle's maintained slot, or one
    prepared on the fly (warned once per slot — a rebuild per call must
    never hide in a serving loop)."""
    eng = get_engine(engine)
    cache = bundle.caches.get(eng.cache_key)
    if cache is None:
        if eng.needs_cache and eng.cache_key not in _REBUILD_WARNED:
            _REBUILD_WARNED.add(eng.cache_key)
            warnings.warn(
                f"bundle_scores(engine={engine!r}): cache slot "
                f"{eng.cache_key!r} is not maintained in this bundle "
                f"(slots: {tuple(bundle.caches)}); rebuilding it on every "
                "call — include the engine in the bundle's engines= to "
                "maintain it (warned once per slot)",
                RuntimeWarning, stacklevel=3)
        cache = eng.prepare(bundle.cfg, bundle.state)
    return cache


def bundle_scores(bundle: TMBundle, x: torch.Tensor, *,
                  engine: str = DEFAULT_ENGINE) -> torch.Tensor:
    """(B, o) uint8 on the bundle's device → (B, m) int32 scores."""
    return get_engine(engine).scores(bundle.cfg, engine_cache(bundle, engine), x)


def bundle_predict(bundle: TMBundle, x: torch.Tensor, *,
                   engine: str = DEFAULT_ENGINE) -> torch.Tensor:
    """(B, o) → (B,) argmax class via a registered engine."""
    return torch.argmax(bundle_scores(bundle, x, engine=engine), dim=-1)


def sync_caches(bundle: TMBundle, new_state: TMState,
                buf: indexing.EventBuffer) -> TMBundle:
    """New bundle whose caches absorbed the buffer's events through their
    providers; the overflow counter accumulates the buffer's."""
    with span("tm.index_sync.apply"):
        caches = {key: cache_provider(key).update_cache(
                      bundle.cfg, cache, new_state, buf.events)
                  for key, cache in bundle.caches.items()}
    overflow = buf.overflow
    if bundle.event_overflow is not None:
        overflow = overflow + bundle.event_overflow
    return TMBundle(cfg=bundle.cfg, state=new_state, caches=caches,
                    event_overflow=overflow, vote_acc=bundle.vote_acc)


def train_step(bundle: TMBundle, xs, ys, draws, mask=None, *,
               parallel: bool = False, max_events: int = 4096) -> TMBundle:
    """One learning step over a batch; every engine cache stays in sync.

    Dense Type I/II feedback (sequential, or the batch-parallel
    approximation when ``parallel``), then the include-mask diff as a
    buffer of at most ``max_events`` boundary crossings, replayed into each
    cache. Crossings past the buffer are dropped and counted into the
    returned bundle's ``event_overflow``: size ``max_events`` to the load
    and check that the counter stays 0.

    ``xs`` (B, o) {0,1} and ``ys`` (B,) labels (arrays or tensors);
    ``draws`` the batch's ``tm.SampleDraws`` or a ``torch.Generator`` to
    draw them from (``tm.draw_sample_draws`` gives the order); ``mask``
    (B,) bool marks valid rows — padded rows consume their draws and apply
    no update. Returns a new bundle; the input bundle is not modified.
    """
    cfg = bundle.cfg
    with span("tm.index_sync.diff"):
        old_inc = include_mask(cfg, bundle.state)
    update = (tm.update_batch_parallel if parallel
              else tm.update_batch_sequential)
    new_state = update(cfg, bundle.state, xs, ys, draws, mask=mask)
    with span("tm.index_sync.diff"):
        buf = indexing.events_from_transition(
            old_inc, include_mask(cfg, new_state), max_events)
    return sync_caches(bundle, new_state, buf)
