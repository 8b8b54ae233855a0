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
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.types import resolve_device

AXIS_NAMES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A (data, model) grid of devices; ``devices`` is row-major (data
    rank major, clause rank minor, as the reference's mesh reshapes)."""

    devices: tuple[torch.device, ...]
    shape: tuple[int, int]

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
