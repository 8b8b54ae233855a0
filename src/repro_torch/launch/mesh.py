"""Device meshes — port of ``repro.launch.mesh`` (``make_host_mesh``).

A ``DeviceMesh`` is a (data × model) grid of ``torch.device``s held by one
process: the port's multi-device path is single-controller, as the
reference's ``shard_map`` programs are. Axis ``data`` splits the batch (and,
for sequential learning, clause sub-slices); axis ``model`` splits the
clauses.

``make_mesh`` builds one and never switches device on its own:

  * no ``devices`` → ``cuda:0 … cuda:k-1``, and it raises when the machine
    has fewer than ``k = data · model`` cards (or none);
  * ``device="cpu"`` without a list → ``["cpu"] * k``, the CPU that the
    caller asked for;
  * an explicit ``devices`` list may repeat a device: ``["cpu"] * k`` for
    tests, ``["cuda:0"] * k`` to run k shards on one card.

The sharded LM path (``repro_torch.sharding``) addresses the grid by axis
name: ``axis_size``, ``axis_index`` and ``axis_groups`` (the ranks that
share every coordinate but those along the named axes). Each mesh carries
a ``CollectiveCounter``: every collective of ``repro_torch.sharding`` over
a group of more than one rank adds its call and its payload bytes there.
"""
from __future__ import annotations

import collections
import dataclasses

import torch

from repro_torch.core.types import resolve_device

AXIS_NAMES = ("data", "model")


class CollectiveCounter:
    """Calls and payload bytes of the collectives run over a mesh, keyed
    ``"<kind>/<axes>"`` (``"psum/model"``, ``"all_gather/data"``, …). The
    payload of a call is the bytes of every participating rank's input."""

    def __init__(self):
        self.calls: collections.Counter = collections.Counter()
        self.bytes: collections.Counter = collections.Counter()

    def record(self, kind: str, axes: tuple, nbytes: int) -> None:
        """One call of ``kind`` over ``axes`` moving ``nbytes``."""
        key = f"{kind}/{'+'.join(axes)}"
        self.calls[key] += 1
        self.bytes[key] += int(nbytes)

    def reset(self) -> None:
        """Set every count to 0."""
        self.calls.clear()
        self.bytes.clear()

    def snapshot(self) -> dict:
        """``{"calls": {key: n}, "bytes": {key: n}}`` as plain dicts."""
        return {"calls": dict(self.calls), "bytes": dict(self.bytes)}


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A (data, model) grid of devices; ``devices`` is row-major (data
    rank major, clause rank minor, as the reference's mesh reshapes).
    Rank ``r`` is ``(r // model, r % model)``."""

    devices: tuple[torch.device, ...]
    shape: tuple[int, int]
    collectives: CollectiveCounter = dataclasses.field(
        default_factory=CollectiveCounter, compare=False, repr=False)

    axis_names = AXIS_NAMES

    def __post_init__(self):
        d, c = self.shape
        if d < 1 or c < 1 or len(self.devices) != d * c:
            raise ValueError(f"mesh shape {self.shape} needs {max(d * c, 1)} "
                             f"devices, got {len(self.devices)}")

    @property
    def data(self) -> int:
        """Size of the ``data`` axis."""
        return self.shape[0]

    @property
    def model(self) -> int:
        """Size of the ``model`` (clause) axis."""
        return self.shape[1]

    def device(self, d: int, c: int) -> torch.device:
        """The device of data rank ``d``, clause rank ``c``."""
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


def axis_size(mesh: DeviceMesh, axes) -> int:
    """Ranks along ``axes`` (a name or a tuple of names; 1 for none)."""
    n = 1
    for a in _axes(axes):
        if a not in AXIS_NAMES:
            raise ValueError(f"unknown mesh axis {a!r}; the axes are {AXIS_NAMES}")
        n *= mesh.shape[AXIS_NAMES.index(a)]
    return n


def axis_index(mesh: DeviceMesh, rank: int, axes) -> int:
    """Rank ``rank``'s coordinate along ``axes``, row-major over the named
    axes in the order given (0 for none)."""
    coords = divmod(rank, mesh.model)
    idx = 0
    for a in _axes(axes):
        k = AXIS_NAMES.index(a)
        idx = idx * mesh.shape[k] + coords[k]
    return idx


def axis_groups(mesh: DeviceMesh, axes) -> list[list[int]]:
    """The ranks partitioned into groups along ``axes``: each group holds
    the ranks that agree on every other axis, ordered by ``axis_index``
    (one rank per group for no axes)."""
    names = _axes(axes)
    rest = [a for a in AXIS_NAMES if a not in names]
    groups: dict = {}
    for r in range(mesh.size):
        coords = divmod(r, mesh.model)
        key = tuple(coords[AXIS_NAMES.index(a)] for a in rest)
        groups.setdefault(key, []).append(r)
    return [sorted(g, key=lambda r: axis_index(mesh, r, names))
            for g in groups.values()]


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
