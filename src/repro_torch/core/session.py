"""TM execution on one device: ``Topology``, ``TMSession``, ``TsetlinMachine``
— port of ``repro.core.session``.

  * ``Topology`` — the placement spec. The port runs on one device; a
    topology over more devices raises ``NotImplementedError``.
  * ``TMSession`` — one (config × device): ``prepare`` / ``init_bundle`` /
    ``train_step`` / ``scores`` / ``predict``, ``fingerprint`` (the serving
    cache key), ``save`` / ``restore`` (schema-v1 checkpoints, readable by
    the reference package), and ``lower_scores``, the counterpart of the
    reference's AOT hook: PyTorch runs eagerly, so it returns a bound
    per-bucket callable with the engine's cache resolved once, up front.
  * ``TsetlinMachine`` — the estimator facade: ``init`` / ``fit`` /
    ``partial_fit`` / ``load`` / ``scores`` / ``predict`` / ``evaluate`` /
    ``save``. Its randomness comes from one ``torch.Generator`` on the
    session's device, seeded by ``seed``.

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


@dataclasses.dataclass(frozen=True)
class Topology:
    """Declarative placement for a TM.

    ``clause_shards`` / ``data_shards`` — kept from the reference; only 1
    (one device) is supported so far. ``engines`` — engine names
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
    """One resolved (config × topology × device).

    ``parallel`` picks the batch-parallel learning mode for ``train_step``
    (default: sequential, the paper's); ``max_events`` sizes its event
    buffer.
    """

    def __init__(self, cfg: TMConfig, topology: Topology | None = None, *,
                 engines: Iterable[str] | None = None, device="cuda",
                 parallel: bool = False, max_events: int = 4096):
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
        self.parallel = parallel
        self.max_events = max_events
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

    def train_step(self, bundle: TMBundle, xs, ys, draws,
                   mask=None) -> TMBundle:
        """One learning step (every maintained cache stays in sync) in this
        session's learning mode; see ``api.train_step``. ``draws`` is the
        batch's ``SampleDraws`` or a ``torch.Generator`` on this session's
        device. Returns a new bundle; the input bundle is not modified."""
        return api.train_step(
            bundle, _as_input(xs, self.cfg.n_features, self.device), ys,
            draws, mask, parallel=self.parallel, max_events=self.max_events)

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

    >>> machine = TsetlinMachine(cfg, seed=0)            # device="cuda"
    >>> machine.init().fit(xs, ys, epochs=3, batch_size=128)
    >>> machine.predict(x_test, engine="indexed")

    ``seed`` seeds the ``torch.Generator`` (on the session's device) that
    every training step draws from, unless a step is handed its draws.
    """

    def __init__(self, cfg: TMConfig, *, topology: Topology | None = None,
                 engines: Iterable[str] | None = None, device="cuda",
                 parallel: bool = False, max_events_per_batch: int = 4096,
                 seed: int = 0):
        self.session = TMSession(cfg, topology, engines=engines, device=device,
                                 parallel=parallel,
                                 max_events=max_events_per_batch)
        self.cfg = self.session.cfg
        self.engines = self.session.engines
        self.device = self.session.device
        self.parallel = parallel
        self.max_events_per_batch = max_events_per_batch
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
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

    def partial_fit(self, xs, ys, draws=None, mask=None) -> "TsetlinMachine":
        """One train step over a batch (every maintained cache kept in
        sync). ``draws`` (the batch's ``SampleDraws``) defaults to the
        machine's generator; ``mask`` (B,) bool marks valid rows — padded
        rows apply no update."""
        bundle = self._ensure_bundle()
        self.bundle = self.session.train_step(
            bundle, xs, ys, self.generator if draws is None else draws, mask)
        return self

    def fit(self, xs, ys, *, epochs: int = 1,
            batch_size: int | None = None) -> "TsetlinMachine":
        """Epoch loop of ``partial_fit``, in fixed-size minibatches when
        ``batch_size`` is set. A trailing partial batch is padded to
        ``batch_size`` with zero rows and masked, so every sample trains once
        per epoch and every step has one shape."""
        n = int(xs.shape[0])
        if batch_size is not None and n < batch_size:
            raise ValueError(
                f"batch_size={batch_size} exceeds dataset size "
                f"{n}: fit would perform zero steps")
        xs = np.asarray(xs.cpu() if isinstance(xs, torch.Tensor) else xs)
        ys = np.asarray(ys.cpu() if isinstance(ys, torch.Tensor) else ys)
        for _ in range(epochs):
            if batch_size is None:
                self.partial_fit(xs, ys)
                continue
            for start in range(0, n, batch_size):
                xb, yb = xs[start:start + batch_size], ys[start:start + batch_size]
                k = xb.shape[0]
                mask = None  # full batches skip the masking work
                if k < batch_size:
                    pad = batch_size - k
                    xb = np.concatenate([xb, np.zeros((pad,) + xb.shape[1:],
                                                      xb.dtype)])
                    yb = np.concatenate([yb, np.zeros((pad,), yb.dtype)])
                    mask = np.arange(batch_size) < k
                self.partial_fit(xb, yb, mask=mask)
        return self

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
        """Cache-sync events dropped since the bundle was prepared. Non-zero
        means ``max_events_per_batch`` was too small for some step and the
        engine caches are stale: a config error. Reading it costs one scalar
        transfer from the device."""
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
