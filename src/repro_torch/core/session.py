"""Topology-aware TM execution: ``Topology``, ``TMSession``,
``TsetlinMachine`` — port of ``repro.core.session``.

  * ``Topology`` — the placement spec: clause shards, data shards, the
    engines whose caches the bundle maintains, and ``async_votes``.
  * ``TMSession`` — resolves a topology once: one device (``api``), or a
    ``DeviceMesh`` (``launch/mesh.py``, built from the shard counts or
    adopted through ``mesh=``) and the sharded factories of
    ``core/distributed.py``. Both give the same ``prepare`` /
    ``init_bundle`` / ``train_step`` / ``scores`` / ``predict``, bit-exact
    with each other; ``refresh_votes`` and the K-step cadence serve
    asynchronous learning. Also ``fingerprint`` (the serving cache key),
    ``describe``, ``save`` / ``restore`` (schema-v1 checkpoints, readable by
    the reference package, topology-free: a restore reshards), and
    ``lower_scores``, the counterpart of the reference's AOT hook: PyTorch
    runs eagerly, so it returns a bound per-bucket callable with the
    engine's caches resolved once, up front.
  * ``TsetlinMachine`` — the estimator facade: ``init`` / ``fit`` /
    ``partial_fit`` / ``load`` / ``scores`` / ``predict`` / ``evaluate`` /
    ``save``. Its randomness comes from one ``torch.Generator`` on the
    session's (first) device, seeded by ``seed``; every shard takes its
    rows of the same full-size draws, so a sharded machine equals
    ``Topology(1)`` on the same device type under the same seed.

Every entry point takes ``device=`` (default ``"cuda"``) and raises when
CUDA is missing, unless the caller asked for ``device="cpu"``. A sharded
topology with no ``mesh=`` takes ``cuda:0 … cuda:k-1`` and raises when the
machine has fewer cards; ``make_mesh(devices=[...])`` places shards
explicitly, several on one device if need be.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Iterable

import numpy as np
import torch

from repro_torch.core import api, distributed
from repro_torch.core.api import DEFAULT_ENGINE, init_bundle
from repro_torch.core.engines import get_engine, registered_engines
from repro_torch.core.types import TMConfig, TMState, init_tm, resolve_device
from repro_torch.launch.mesh import DeviceMesh, make_mesh
from repro_torch.spans import span


@dataclasses.dataclass(frozen=True)
class Topology:
    """Declarative placement for a TM, resolved once by ``TMSession``.

    ``clause_shards`` — ways the clause axis splits over the mesh's
    ``model`` axis. ``data_shards`` — ways the batch splits over its
    ``data`` axis for scoring and batch-parallel learning; sequential
    learning composes it with the clause axis instead
    (``distributed.make_sharded_train_step``). ``engines`` — engine names
    whose caches the bundle maintains (None → every registered engine).
    ``async_votes`` — K > 0 trains against a K-step-stale vote sum (no
    vote reduction inside a step, one per K steps); 0 keeps the bit-exact
    synchronous learning. The reference's ``backend`` and ``donate`` are
    not kept: the device of the tensors picks the kernel, and PyTorch
    frees what nothing references.
    """

    clause_shards: int = 1
    data_shards: int = 1
    engines: tuple[str, ...] | None = None
    async_votes: int = 0

    def __post_init__(self):
        if self.clause_shards < 1 or self.data_shards < 1:
            raise ValueError(
                f"Topology shard counts must be >= 1, got clause_shards="
                f"{self.clause_shards}, data_shards={self.data_shards}")
        if self.async_votes < 0:
            raise ValueError(
                f"async_votes must be >= 0 (0 = synchronous), got "
                f"{self.async_votes}")
        if self.engines is not None and not isinstance(self.engines, tuple):
            object.__setattr__(self, "engines", tuple(self.engines))

    @property
    def n_devices(self) -> int:
        """Devices this topology occupies (``clause_shards · data_shards``)."""
        return self.clause_shards * self.data_shards

    @property
    def is_sharded(self) -> bool:
        """True when the topology needs a mesh (more than one rank)."""
        return self.n_devices > 1

    def describe(self) -> dict:
        """Machine-readable placement summary."""
        return {"clause_shards": self.clause_shards,
                "data_shards": self.data_shards,
                "devices": self.n_devices,
                "async_votes": self.async_votes}


def _topology_of_mesh(mesh: DeviceMesh, topology: Topology) -> Topology:
    """The topology an explicit mesh implements (engines and
    ``async_votes`` kept from ``topology``)."""
    return dataclasses.replace(topology, clause_shards=mesh.model,
                               data_shards=mesh.data)


def _as_input(x, n_features: int, device: torch.device) -> torch.Tensor:
    """(B, o) {0,1} array or tensor → contiguous uint8 tensor on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint8))
    if x.dim() != 2 or x.shape[1] != n_features:
        raise ValueError(f"inputs must be (B, {n_features}), got {tuple(x.shape)}")
    return x.to(device=device, dtype=torch.uint8).contiguous()


class TMSession:
    """One resolved (config × topology × devices).

    A one-rank topology binds the single-device functions of ``api`` on
    ``device``; a larger one builds a ``DeviceMesh`` (or adopts ``mesh=``,
    whose shape then sets the shard counts) and binds the sharded
    factories. ``device`` is then the first rank's device: inputs,
    generators and scores live there. ``parallel`` picks the batch-parallel
    learning mode for ``train_step`` (default: sequential, the paper's);
    ``max_events`` sizes the event buffer (per clause shard when sharded).
    """

    def __init__(self, cfg: TMConfig, topology: Topology | None = None, *,
                 mesh: DeviceMesh | None = None,
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
        if mesh is not None:
            topology = _topology_of_mesh(mesh, topology)
        self.cfg = cfg
        self.topology = topology
        self.parallel = parallel
        self.max_events = max_events
        self.engines = (topology.engines if topology.engines is not None
                        else registered_engines())
        for name in self.engines:
            get_engine(name)  # unknown names fail here, not mid-serving
        self._scores_fns: dict[str, Callable] = {}
        self._refresh = None
        self._pending_steps = 0  # steps since the last stale-vote refresh
        self.mesh = self.geometry = self._prepare = self._step = None

        if not topology.is_sharded:
            if topology.async_votes > 0:
                raise ValueError(
                    f"Topology(async_votes={topology.async_votes}) needs a "
                    "sharded placement: on one device there is no vote "
                    "reduction to make asynchronous; use clause_shards/"
                    "data_shards > 1 (or async_votes=0)")
            self.device = (mesh.devices[0] if mesh is not None
                           else resolve_device(device))
            return

        if mesh is None:
            try:
                mesh = make_mesh(topology.data_shards, topology.clause_shards,
                                 device=device)
            except RuntimeError as e:
                raise RuntimeError(
                    f"Topology(clause_shards={topology.clause_shards}, "
                    f"data_shards={topology.data_shards}) needs "
                    f"{topology.n_devices} devices: {e}") from None
        self.mesh = mesh
        self.device = mesh.device(0, 0)
        self.geometry = distributed.geometry(cfg, mesh)
        self._prepare = distributed.make_sharded_prepare(
            cfg, mesh, engines=self.engines, async_votes=topology.async_votes)
        self._step = distributed.make_sharded_train_step(
            cfg, mesh, engines=self.engines, parallel=parallel,
            max_events=max_events, async_votes=topology.async_votes)
        if topology.async_votes > 0:
            self._refresh = distributed.make_vote_refresh(cfg, mesh,
                                                          parallel=parallel)

    # -- placement ----------------------------------------------------------

    @property
    def is_sharded(self) -> bool:
        """True when this session resolved onto a mesh."""
        return self.mesh is not None

    def unpad_state(self, state: TMState) -> TMState:
        """Global ``(m, n_clauses, 2o)`` view of a (possibly padded) state:
        the estimator's ``state``, checkpoints and cross-topology
        comparisons all go through it, so padding never leaves the session."""
        return distributed.unpad_state(self.cfg, state)

    def describe(self) -> dict:
        """Placement summary, the device(s), the kernel route and the
        composition rule: ``single`` on one device, ``batch_parallel`` in
        the parallel learning mode, else the sharded rule
        (``composed_even`` / ``composed_ragged`` / ``replicated`` /
        ``clause_only``). ``shard_rows`` is the per-clause-shard census of
        real and padding rows."""
        d = self.topology.describe()
        d["sharded"] = self.is_sharded
        d["backend"] = "cuda" if self.device.type == "cuda" else "plain"
        d["device"] = str(self.device)
        if self.geometry is None:
            d["composition"] = "single"
            d["shard_rows"] = [{"shard": 0, "real_rows": self.cfg.n_clauses,
                                "pad_rows": 0}]
        else:
            d["mesh"] = [str(x) for x in self.mesh.devices]
            d["composition"] = ("batch_parallel" if self.parallel
                                else self.geometry.composition)
            d["shard_rows"] = self.geometry.shard_rows()
        return d

    # -- bundle lifecycle ---------------------------------------------------

    def prepare(self, state: TMState):
        """Bundle with this session's caches built from ``state``: a
        ``TMBundle`` on this session's device, or a ``ShardedBundle`` with
        every cache built shard by shard on the ranks' devices."""
        if self._prepare is not None:
            return self._prepare(state)
        return init_bundle(self.cfg, engines=self.engines, state=state,
                           device=self.device)

    def init_bundle(self):
        """Freshly initialised bundle (all TAs exclude)."""
        return self.prepare(init_tm(self.cfg, self.device))

    def train_step(self, bundle, xs, ys, draws, mask=None):
        """One learning step (every maintained cache stays in sync) in this
        session's learning mode; see ``api.train_step``. ``draws`` is the
        batch's ``SampleDraws`` or a ``torch.Generator`` on this session's
        device. Returns a new bundle; the input bundle is not modified.

        Under ``async_votes=K`` the step reduces no vote; the session counts
        steps and runs the refresh (one reduction) after every K-th."""
        with span("tm.train_step"):
            with span("tm.train_step.input"):
                xs = _as_input(xs, self.cfg.n_features, self.device)
            if self._step is None:
                return api.train_step(bundle, xs, ys, draws, mask,
                                      parallel=self.parallel,
                                      max_events=self.max_events)
            d = self.topology.data_shards
            if self.parallel and xs.shape[0] % d:
                raise ValueError(
                    f"batch size {xs.shape[0]} does not divide over "
                    f"data_shards={d} (batch-parallel learning shards the "
                    "batch); pick a divisible batch_size")
            bundle = self._step(bundle, xs, ys, draws, mask)
            if self._refresh is not None:
                self._pending_steps += 1
                if self._pending_steps >= self.topology.async_votes:
                    bundle = self.refresh_votes(bundle)
            return bundle

    def refresh_votes(self, bundle):
        """Run the stale-vote refresh now (and restart the K-step count):
        the stale terms take the ranks' latest votes, and the ranks'
        dropped-event counts drain into ``event_overflow``, which lags
        between refreshes. A no-op outside asynchronous learning."""
        if self._refresh is None:
            return bundle
        self._pending_steps = 0
        return self._refresh(bundle)

    # -- execution ----------------------------------------------------------

    def _sharded_scores_fn(self, engine: str) -> Callable:
        """Memoised ``make_sharded_scores`` for one engine."""
        fn = self._scores_fns.get(engine)
        if fn is None:
            fn = distributed.make_sharded_scores(self.cfg, self.mesh,
                                                 engine=engine)
            self._scores_fns[engine] = fn
        return fn

    def scores(self, bundle, x, *, engine: str = DEFAULT_ENGINE) -> torch.Tensor:
        """(B, o) inputs → (B, m) int32 class scores through a registry
        engine, on this session's device (sharded: ``B`` must be a
        multiple of ``data_shards``)."""
        with span("tm.scores"):
            with span("tm.scores.input"):
                x = _as_input(x, self.cfg.n_features, self.device)
            with span("tm.scores.engine"):
                if self.mesh is None:
                    return api.bundle_scores(bundle, x, engine=engine)
                return self._sharded_scores_fn(engine)(bundle, x)

    def predict(self, bundle, x, *,
                engine: str = DEFAULT_ENGINE) -> torch.Tensor:
        """(B, o) inputs → (B,) argmax class through a registry engine."""
        return torch.argmax(self.scores(bundle, x, engine=engine), dim=-1)

    def fingerprint(self) -> str:
        """Short stable id of (config × placement × devices): the serving
        bucket cache's key. Built from the checkpoint fingerprint plus
        ``describe()``."""
        from repro_torch.checkpoint.tm_store import config_fingerprint
        blob = repr(sorted(self.describe().items())).encode()
        blob += bytes(bytearray(config_fingerprint(self.cfg)))
        return hashlib.sha256(blob).hexdigest()[:16]

    def lower_scores(self, bundle, batch_size: int, *,
                     engine: str = DEFAULT_ENGINE) -> Callable:
        """Bound scores callable for one padded batch shape.

        The engine's cache (every rank's, when sharded) is resolved here,
        once: a single-device bundle that does not maintain it gets one
        built now, not per call; a sharded bundle must maintain it. The
        callable takes a ``(batch_size, n_features)`` uint8 tensor on this
        session's device and returns the ``(batch_size, m)`` int32 scores
        without waiting for the device; sharded, one call is one
        ``make_sharded_scores`` call.
        """
        shape = (batch_size, self.cfg.n_features)
        if self.mesh is None:
            eng = get_engine(engine)
            cache, cfg = api.engine_cache(bundle, engine), bundle.cfg

            def run(x):
                return eng.scores(cfg, cache, x)
        else:
            fn = self._sharded_scores_fn(engine)
            ops = fn.operands(bundle)

            def run(x):
                return fn.evaluate(ops, x)

        def scores_for_bucket(x: torch.Tensor) -> torch.Tensor:
            if tuple(x.shape) != shape or x.dtype != torch.uint8:
                raise ValueError(f"bucket callable takes {shape} uint8, got "
                                 f"{tuple(x.shape)} {x.dtype}")
            return run(x)

        return scores_for_bucket

    # -- checkpointing (schema v1: state + config fingerprint) --------------

    def save(self, directory, bundle, *, step: int = 0,
             keep: int = 3, blocking: bool = True) -> None:
        """Write a schema-v1 checkpoint of the bundle's global TA state,
        always the unpadded ``(m, n_clauses, 2o)`` view: checkpoints are
        topology-free."""
        from repro_torch.checkpoint import tm_store
        tm_store.save_tm(directory, self.cfg,
                         self.unpad_state(bundle.state).ta_state,
                         step=step, keep=keep, blocking=blocking)

    def restore(self, directory, *, step: int | None = None):
        """(bundle, step) from a schema-v1 checkpoint (written by either
        package, under any topology): the state lands on this session's
        placement and every cache rebuilds there (reshard-on-restore); an
        asynchronous session's accumulator starts from zeros."""
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
    >>> TsetlinMachine(cfg, topology=Topology(clause_shards=4),
    ...                mesh=make_mesh(1, 4, devices=["cuda:0"] * 4))

    The topology is transparent: the same script runs on one device or
    sharded, bit-exactly. ``seed`` seeds the ``torch.Generator`` (on the
    session's first device) that every training step draws from, unless a
    step is handed its draws.
    """

    def __init__(self, cfg: TMConfig, *, topology: Topology | None = None,
                 mesh: DeviceMesh | None = None,
                 engines: Iterable[str] | None = None, device="cuda",
                 parallel: bool = False, max_events_per_batch: int = 4096,
                 seed: int = 0):
        self.session = TMSession(cfg, topology, mesh=mesh, engines=engines,
                                 device=device, parallel=parallel,
                                 max_events=max_events_per_batch)
        self.cfg = self.session.cfg
        self.engines = self.session.engines
        self.device = self.session.device
        self.parallel = parallel
        self.max_events_per_batch = max_events_per_batch
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.bundle = None   # a TMBundle, or a ShardedBundle when sharded

    @property
    def topology(self) -> Topology:
        """The placement this machine's session resolved."""
        return self.session.topology

    # -- lifecycle ----------------------------------------------------------

    def init(self) -> "TsetlinMachine":
        """(Re)initialise the bundle (all TAs exclude)."""
        self.bundle = self.session.init_bundle()
        return self

    def _ensure_bundle(self):
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
        transfer from the device. Sharded, the buffer holds
        ``max_events_per_batch`` per clause shard; under ``async_votes`` the
        count lags until the next refresh."""
        bundle = self.bundle
        if bundle is None or bundle.event_overflow is None:
            return 0
        return int(bundle.event_overflow)

    @property
    def state(self) -> TMState:
        """The global ``(m, n_clauses, 2o)`` TA state (never padded, so
        states compare bit-exactly across topologies)."""
        return self.session.unpad_state(self._ensure_bundle().state)

    @property
    def index(self):
        """The paper's clause index (sharded: one per clause shard, with
        local clause ids)."""
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
        """Restore a checkpoint written by either package onto any
        topology (the state reshards, caches rebuild there); raises
        ``CheckpointMismatch`` when ``cfg`` does not fingerprint-match."""
        machine = cls(cfg, topology=topology, **kwargs)
        machine.bundle, _ = machine.session.restore(directory, step=step)
        return machine
