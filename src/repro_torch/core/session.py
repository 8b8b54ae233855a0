"""TM execution on one device: ``Topology``, ``TMSession``, ``TsetlinMachine``
— port of ``repro.core.session`` (serving half).

  * ``Topology`` — the placement spec. This slice runs on one device; a
    topology over more devices raises ``NotImplementedError``.
  * ``TMSession`` — one (config × device): ``prepare`` / ``init_bundle`` /
    ``scores`` / ``predict``, ``fingerprint`` (the serving cache key),
    ``save`` / ``restore`` (schema-v1 checkpoints, readable by the reference
    package), and ``lower_scores``, the counterpart of the reference's AOT
    hook: PyTorch runs eagerly, so it returns a bound per-bucket callable
    with the engine's cache resolved once, up front.
  * ``TsetlinMachine`` — the estimator facade: ``init`` / ``load`` /
    ``scores`` / ``predict`` / ``evaluate`` / ``save``. ``fit`` and
    ``partial_fit`` come with training in the next slice.

Every entry point takes ``device=`` (default ``"cuda"``) and raises when
CUDA is missing, unless the caller asked for ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Iterable

import numpy as np
import torch

from repro_torch.core import api, indexing
from repro_torch.core.api import DEFAULT_ENGINE, TMBundle, init_bundle
from repro_torch.core.engines import get_engine, registered_engines
from repro_torch.core.types import TMConfig, TMState, init_tm, resolve_device

_TRAINING = ("training (fit / partial_fit / train_step) comes in slice 2 of "
             "the PyTorch port; this slice serves")


@dataclasses.dataclass(frozen=True)
class Topology:
    """Declarative placement for a TM.

    ``clause_shards`` / ``data_shards`` — kept from the reference; only 1
    (one device) is supported in this slice. ``engines`` — engine names
    whose caches the bundle maintains (None → every registered engine).
    The reference's ``backend`` override is not kept: the device of the
    tensors picks the kernel.
    """

    clause_shards: int = 1
    data_shards: int = 1
    engines: tuple[str, ...] | None = None

    def __post_init__(self):
        if self.clause_shards < 1 or self.data_shards < 1:
            raise ValueError(
                f"Topology shard counts must be >= 1, got clause_shards="
                f"{self.clause_shards}, data_shards={self.data_shards}")
        if self.n_devices > 1:
            raise NotImplementedError(
                f"Topology(clause_shards={self.clause_shards}, data_shards="
                f"{self.data_shards}) spans {self.n_devices} devices; "
                "multi-device topologies come in a later slice of the "
                "PyTorch port")
        if self.engines is not None and not isinstance(self.engines, tuple):
            object.__setattr__(self, "engines", tuple(self.engines))

    @property
    def n_devices(self) -> int:
        """Devices this topology occupies (``clause_shards · data_shards``)."""
        return self.clause_shards * self.data_shards

    def describe(self) -> dict:
        """Machine-readable placement summary."""
        return {"clause_shards": self.clause_shards,
                "data_shards": self.data_shards,
                "devices": self.n_devices}


def _as_input(x, n_features: int, device: torch.device) -> torch.Tensor:
    """(B, o) {0,1} array or tensor → contiguous uint8 tensor on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint8))
    if x.dim() != 2 or x.shape[1] != n_features:
        raise ValueError(f"inputs must be (B, {n_features}), got {tuple(x.shape)}")
    return x.to(device=device, dtype=torch.uint8).contiguous()


class TMSession:
    """One resolved (config × topology × device)."""

    def __init__(self, cfg: TMConfig, topology: Topology | None = None, *,
                 engines: Iterable[str] | None = None, device="cuda"):
        if topology is None:
            topology = Topology(
                engines=tuple(engines) if engines is not None else None)
        elif engines is not None:
            if (topology.engines is not None
                    and topology.engines != tuple(engines)):
                raise ValueError(
                    f"conflicting engines: topology says {topology.engines}, "
                    f"call says {tuple(engines)}")
            topology = dataclasses.replace(topology, engines=tuple(engines))
        self.device = resolve_device(device)
        self.cfg = cfg
        self.topology = topology
        self.engines = (topology.engines if topology.engines is not None
                        else registered_engines())
        for name in self.engines:
            get_engine(name)  # unknown names fail here, not mid-serving

    def describe(self) -> dict:
        """Placement summary + the device and kernel route."""
        d = self.topology.describe()
        d["backend"] = "cuda" if self.device.type == "cuda" else "plain"
        d["device"] = str(self.device)
        return d

    # -- bundle lifecycle ---------------------------------------------------

    def prepare(self, state: TMState) -> TMBundle:
        """Bundle on this session's device with its engines' caches built."""
        return init_bundle(self.cfg, engines=self.engines, state=state,
                           device=self.device)

    def init_bundle(self) -> TMBundle:
        """Freshly initialised bundle (all TAs exclude)."""
        return self.prepare(init_tm(self.cfg, self.device))

    def train_step(self, *args, **kwargs):
        """Not in this slice."""
        raise NotImplementedError(_TRAINING)

    # -- execution ----------------------------------------------------------

    def scores(self, bundle: TMBundle, x, *,
               engine: str = DEFAULT_ENGINE) -> torch.Tensor:
        """(B, o) inputs → (B, m) int32 class scores through a registry
        engine, on this session's device."""
        return api.bundle_scores(
            bundle, _as_input(x, self.cfg.n_features, self.device),
            engine=engine)

    def predict(self, bundle: TMBundle, x, *,
                engine: str = DEFAULT_ENGINE) -> torch.Tensor:
        """(B, o) inputs → (B,) argmax class through a registry engine."""
        return torch.argmax(self.scores(bundle, x, engine=engine), dim=-1)

    def fingerprint(self) -> str:
        """Short stable id of (config × placement × device): the serving
        bucket cache's key. Built from the checkpoint fingerprint plus
        ``describe()``."""
        from repro_torch.checkpoint.tm_store import config_fingerprint
        blob = repr(sorted(self.describe().items())).encode()
        blob += bytes(bytearray(config_fingerprint(self.cfg)))
        return hashlib.sha256(blob).hexdigest()[:16]

    def lower_scores(self, bundle: TMBundle, batch_size: int, *,
                     engine: str = DEFAULT_ENGINE) -> Callable:
        """Bound scores callable for one padded batch shape.

        The engine's cache is resolved here, once (a bundle that does not
        maintain it gets one built now, not per call). The callable takes a
        ``(batch_size, n_features)`` uint8 tensor on this session's device
        and returns the ``(batch_size, m)`` int32 scores without waiting for
        the device.
        """
        eng = get_engine(engine)
        cache = api.engine_cache(bundle, engine)
        cfg, shape = bundle.cfg, (batch_size, self.cfg.n_features)

        def scores_for_bucket(x: torch.Tensor) -> torch.Tensor:
            if tuple(x.shape) != shape or x.dtype != torch.uint8:
                raise ValueError(f"bucket callable takes {shape} uint8, got "
                                 f"{tuple(x.shape)} {x.dtype}")
            return eng.scores(cfg, cache, x)

        return scores_for_bucket

    # -- checkpointing (schema v1: state + config fingerprint) --------------

    def save(self, directory, bundle: TMBundle, *, step: int = 0,
             keep: int = 3, blocking: bool = True) -> None:
        """Write a schema-v1 checkpoint of the bundle's TA state."""
        from repro_torch.checkpoint import tm_store
        tm_store.save_tm(directory, self.cfg, bundle.state.ta_state,
                         step=step, keep=keep, blocking=blocking)

    def restore(self, directory, *, step: int | None = None):
        """(bundle, step) from a schema-v1 checkpoint (written by either
        package); caches rebuild on this session's device."""
        from repro_torch.checkpoint import tm_store
        shape = (self.cfg.n_classes, self.cfg.n_clauses, self.cfg.n_literals)
        ta, step = tm_store.load_tm(directory, self.cfg,
                                    torch.empty(shape, device="meta"),
                                    step=step, device=self.device)
        return self.prepare(TMState(ta_state=ta)), step


class TsetlinMachine:
    """Estimator facade over a ``TMSession``.

    >>> machine = TsetlinMachine.load(directory, cfg)   # device="cuda"
    >>> machine.predict(x_test, engine="indexed")
    """

    def __init__(self, cfg: TMConfig, *, topology: Topology | None = None,
                 engines: Iterable[str] | None = None, device="cuda"):
        self.session = TMSession(cfg, topology, engines=engines, device=device)
        self.cfg = self.session.cfg
        self.engines = self.session.engines
        self.device = self.session.device
        self.bundle: TMBundle | None = None

    @property
    def topology(self) -> Topology:
        """The placement this machine's session resolved."""
        return self.session.topology

    # -- lifecycle ----------------------------------------------------------

    def init(self) -> "TsetlinMachine":
        """(Re)initialise the bundle (all TAs exclude)."""
        self.bundle = self.session.init_bundle()
        return self

    def _ensure_bundle(self) -> TMBundle:
        if self.bundle is None:
            self.init()
        return self.bundle

    # -- learning -----------------------------------------------------------

    def partial_fit(self, *args, **kwargs):
        """Not in this slice."""
        raise NotImplementedError(_TRAINING)

    def fit(self, *args, **kwargs):
        """Not in this slice."""
        raise NotImplementedError(_TRAINING)

    # -- inference ----------------------------------------------------------

    def scores(self, xs, *, engine: str = DEFAULT_ENGINE) -> torch.Tensor:
        """(B, o) inputs → (B, m) class scores through a registry engine."""
        return self.session.scores(self._ensure_bundle(), xs, engine=engine)

    def predict(self, xs, *, engine: str = DEFAULT_ENGINE) -> torch.Tensor:
        """(B, o) inputs → (B,) argmax class through a registry engine."""
        return self.session.predict(self._ensure_bundle(), xs, engine=engine)

    def evaluate(self, xs, ys, *, engine: str = DEFAULT_ENGINE) -> float:
        """Mean prediction accuracy of ``xs`` against labels ``ys``."""
        pred = self.predict(xs, engine=engine)
        ys = torch.as_tensor(np.asarray(ys), device=pred.device)
        return float((pred == ys).to(torch.float32).mean())

    # -- state access / persistence -----------------------------------------

    @property
    def event_overflow(self) -> int:
        """Cache-sync events dropped in training (0: nothing trains yet)."""
        bundle = self.bundle
        if bundle is None or bundle.event_overflow is None:
            return 0
        return int(bundle.event_overflow)

    @property
    def state(self) -> TMState:
        """The ``(m, n_clauses, 2o)`` TA state."""
        return self._ensure_bundle().state

    @property
    def index(self) -> indexing.ClauseIndex:
        """The paper's clause index."""
        return self._ensure_bundle().index

    def save(self, directory, *, step: int = 0, keep: int = 3,
             blocking: bool = True) -> "TsetlinMachine":
        """Versioned checkpoint (schema v1): TA state + config fingerprint."""
        self.session.save(directory, self._ensure_bundle(), step=step,
                          keep=keep, blocking=blocking)
        return self

    @classmethod
    def load(cls, directory, cfg: TMConfig, *,
             topology: Topology | None = None, step: int | None = None,
             **kwargs) -> "TsetlinMachine":
        """Restore a checkpoint written by either package; raises
        ``CheckpointMismatch`` when ``cfg`` does not fingerprint-match."""
        machine = cls(cfg, topology=topology, **kwargs)
        machine.bundle, _ = machine.session.restore(directory, step=step)
        return machine
