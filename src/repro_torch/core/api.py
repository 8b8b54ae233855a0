"""TM bundle API — port of ``repro.core.api`` (serving half).

``TMBundle`` bundles the ``TMConfig`` with the TA state and the
per-``cache_key`` engine caches: one value carries everything needed to
serve through any registered engine. ``train_step`` and ``sync_caches``
come with training in the next slice.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Iterable

import torch

from repro_torch.core import indexing
from repro_torch.core.engines import cache_provider, get_engine, registered_engines
from repro_torch.core.types import TMConfig, TMState, init_tm, resolve_device

DEFAULT_ENGINE = "indexed"


@dataclasses.dataclass(frozen=True)
class TMBundle:
    """Config + TA state + engine caches.

    ``event_overflow`` counts cache-sync events dropped during training
    (a 0-d int32 tensor; always 0 until training is ported).
    """

    cfg: TMConfig
    state: TMState
    caches: dict[str, Any]
    event_overflow: torch.Tensor | None = None

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
