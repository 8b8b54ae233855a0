"""Device meshes — port of ``repro.launch.mesh`` (``make_host_mesh``,
``make_production_mesh``).

A ``DeviceMesh`` is a (data × model) grid of ``torch.device``s held by one
process: the port's multi-device path is single-controller, as the
reference's ``shard_map`` programs are. Axis ``data`` splits the batch (and,
for sequential learning, clause sub-slices); axis ``model`` splits the
clauses. A ``DeviceMesh`` may carry a leading ``pod`` axis, (pod × data ×
model), as the reference's multi-pod mesh does: pure data parallelism,
the batch split over ``("pod", "data")``; only the LM path reads it, and
the TM's meshes stay two-axis.

``make_mesh`` builds one and never switches device on its own:

  * no ``devices`` → ``cuda:0 … cuda:k-1``, and it raises when the machine
    has fewer than ``k = data · model`` cards (or none);
  * ``device="cpu"`` without a list → ``["cpu"] * k``, the CPU that the
    caller asked for;
  * an explicit ``devices`` list may repeat a device: ``["cpu"] * k`` for
    tests, ``["cuda:0"] * k`` to run k shards on one card.

``make_trace_mesh`` / ``make_production_mesh`` put every rank on one device
for ``launch.trace``'s fake tensors: the production meshes (16 × 16 and
2 × 16 × 16) exist only there, where a rank needs no card of its own.

The sharded LM path (``repro_torch.sharding``) addresses the grid by axis
name: ``axis_size``, ``axis_index`` and ``axis_groups`` (the ranks that
share every coordinate but those along the named axes). Each mesh carries
a ``CollectiveCounter``: every collective of ``repro_torch.sharding`` over
a group of more than one rank adds its call and its payload bytes there.
"""
from __future__ import annotations

import collections
import dataclasses
import functools

import torch

from repro_torch.core.types import resolve_device

AXIS_NAMES = ("data", "model")
POD_AXIS_NAMES = ("pod", "data", "model")


class CollectiveCounter:
    """Calls and payload bytes of the collectives run over a mesh, keyed
    ``"<kind>/<axes>"`` (``"psum/model"``, ``"all_gather/data"``, …). The
    payload of a call is the bytes of every participating rank's input.

    ``schedule``, when set to a list, receives ``(kind, nbytes, axes)`` of
    every call in program order. ``observer``, when set (``launch.trace``
    while it traces), runs every collective of ``repro_torch.sharding``:
    ``observer(fn, xs, mesh, *args)`` calls ``fn`` and returns its result."""

    def __init__(self):
        self.calls: collections.Counter = collections.Counter()
        self.bytes: collections.Counter = collections.Counter()
        self.schedule: list | None = None
        self.observer = None

    def record(self, kind: str, axes: tuple, nbytes: int) -> None:
        """One call of ``kind`` over ``axes`` moving ``nbytes``."""
        key = f"{kind}/{'+'.join(axes)}"
        self.calls[key] += 1
        self.bytes[key] += int(nbytes)
        if self.schedule is not None:
            self.schedule.append((kind, int(nbytes), tuple(axes)))

    def reset(self) -> None:
        """Set every count to 0."""
        self.calls.clear()
        self.bytes.clear()
        if self.schedule is not None:
            self.schedule.clear()

    def snapshot(self) -> dict:
        """``{"calls": {key: n}, "bytes": {key: n}}`` as plain dicts."""
        return {"calls": dict(self.calls), "bytes": dict(self.bytes)}


def _size(shape: tuple) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A (data, model) or (pod, data, model) grid of devices; ``devices`` is
    row-major (data rank major, clause rank minor, as the reference's mesh
    reshapes). On a two-axis mesh rank ``r`` is ``(r // model, r % model)``."""

    devices: tuple[torch.device, ...]
    shape: tuple[int, ...]
    collectives: CollectiveCounter = dataclasses.field(
        default_factory=CollectiveCounter, compare=False, repr=False)

    def __post_init__(self):
        n = _size(self.shape)
        if (len(self.shape) not in (2, 3) or min(self.shape) < 1
                or len(self.devices) != n):
            raise ValueError(f"mesh shape {self.shape} needs {max(n, 1)} "
                             f"devices, got {len(self.devices)}")

    @property
    def axis_names(self) -> tuple[str, ...]:
        """``("data", "model")``, or ``("pod", "data", "model")``."""
        return AXIS_NAMES if len(self.shape) == 2 else POD_AXIS_NAMES

    @property
    def data(self) -> int:
        """Size of the ``data`` axis."""
        return self.shape[-2]

    @property
    def model(self) -> int:
        """Size of the ``model`` (clause) axis."""
        return self.shape[-1]

    def device(self, d: int, c: int) -> torch.device:
        """The device of data rank ``d``, clause rank ``c`` (a two-axis
        mesh: the TM's)."""
        if len(self.shape) != 2:
            raise ValueError(f"device(d, c) needs a (data, model) mesh, not "
                             f"{self.axis_names}")
        return self.devices[d * self.model + c]

    @property
    def size(self) -> int:
        """Number of ranks."""
        return len(self.devices)


def _axes(axes) -> tuple:
    """An axis name, a tuple of names, or None → a tuple of names."""
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _coords(shape: tuple, rank: int) -> tuple:
    """Rank ``rank``'s coordinate on each axis of a row-major grid."""
    out = []
    for s in reversed(shape):
        rank, c = divmod(rank, s)
        out.append(c)
    return tuple(reversed(out))


def _axis_dims(mesh: DeviceMesh, axes) -> tuple:
    names = mesh.axis_names
    for a in _axes(axes):
        if a not in names:
            raise ValueError(f"unknown mesh axis {a!r}; the axes are {names}")
    return tuple(names.index(a) for a in _axes(axes))


def axis_size(mesh: DeviceMesh, axes) -> int:
    """Ranks along ``axes`` (a name or a tuple of names; 1 for none)."""
    n = 1
    for k in _axis_dims(mesh, axes):
        n *= mesh.shape[k]
    return n


def axis_index(mesh: DeviceMesh, rank: int, axes) -> int:
    """Rank ``rank``'s coordinate along ``axes``, row-major over the named
    axes in the order given (0 for none)."""
    coords = _coords(mesh.shape, rank)
    idx = 0
    for k in _axis_dims(mesh, axes):
        idx = idx * mesh.shape[k] + coords[k]
    return idx


@functools.lru_cache(maxsize=1024)
def _groups(shape: tuple, dims: tuple) -> tuple:
    rest = [k for k in range(len(shape)) if k not in dims]
    groups: dict = {}
    for r in range(_size(shape)):
        coords = _coords(shape, r)
        key = tuple(coords[k] for k in rest)
        groups.setdefault(key, []).append(r)

    def along(r):
        coords, idx = _coords(shape, r), 0
        for k in dims:
            idx = idx * shape[k] + coords[k]
        return idx

    return tuple(tuple(sorted(g, key=along)) for g in groups.values())


def axis_groups(mesh: DeviceMesh, axes) -> list[list[int]]:
    """The ranks partitioned into groups along ``axes``: each group holds
    the ranks that agree on every other axis, ordered by ``axis_index``
    (one rank per group for no axes)."""
    return [list(g) for g in _groups(tuple(mesh.shape), _axis_dims(mesh, axes))]


def axis_ranks(mesh: DeviceMesh, rank: int, axes) -> list[int]:
    """The ranks along ``axes`` through ``rank`` (its group), ordered by
    their coordinate."""
    return next(g for g in axis_groups(mesh, axes) if rank in g)


def make_mesh(data: int = 1, model: int = 1, *, devices=None,
              device="cuda") -> DeviceMesh:
    """A ``data × model`` mesh (see the module docstring for the cases)."""
    n = data * model
    if n < 1:
        raise ValueError(f"mesh needs data, model >= 1, got {(data, model)}")
    if devices is None:
        kind = resolve_device(device).type
        if kind == "cpu":
            devices = ["cpu"] * n
        else:
            have = torch.cuda.device_count()
            if have < n:
                raise RuntimeError(
                    f"need {n} devices, have {have} CUDA device(s); pass "
                    f"devices=[...] (a device may repeat, e.g. "
                    f"['cuda:0'] * {n}) to place several shards on one card")
            devices = [f"cuda:{i}" for i in range(n)]
    devs = tuple(resolve_device(x) for x in devices)
    if len(devs) != n:
        raise ValueError(f"a {data}x{model} mesh needs {n} devices, "
                         f"got {len(devs)}")
    return DeviceMesh(devices=devs, shape=(data, model))


def _fake_mode_active() -> bool:
    """Whether a ``FakeTensorMode`` is active: a new tensor is fake."""
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(torch.empty(0), FakeTensor)


def make_trace_mesh(*shape: int, device="cuda") -> DeviceMesh:
    """A ``shape`` mesh (two axes, or three with ``pod`` first) whose every
    rank is ``device`` (``cuda`` means ``cuda:0``), for ``launch.trace``.
    Under a ``FakeTensorMode`` nothing is placed, so any size works;
    outside one the device is resolved as ``make_mesh`` resolves it, so a
    CUDA trace mesh raises on a machine without CUDA."""
    dev = torch.device(device)
    if not _fake_mode_active():
        dev = resolve_device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return DeviceMesh(devices=(dev,) * _size(shape), shape=tuple(shape))


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> DeviceMesh:
    """The reference's production mesh as a trace mesh: 16 × 16 (``data``,
    ``model``; 256 ranks) or 2 × 16 × 16 (``pod``, ``data``, ``model``;
    512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    return make_trace_mesh(*shape, device=device)
