"""Kernel registry: one declaration per TM primitive, two bodies.

Port of ``repro.kernels.backend``. Every primitive is registered with

  * a **plain** body — PyTorch tensor code, the semantics oracle, runnable
    on any device;
  * a **kernel** body — the hand-written CUDA kernel for Hopper.

The device of the tensors chooses between them, and nothing else does: a
CPU tensor takes the plain body; a CUDA tensor launches the kernel, which
raises if it cannot build or launch. There is no environment override and no
fallback from the kernel to the plain body. ``TMConfig.backend`` survives
for config and checkpoint compatibility and takes only ``'auto'``.

Registered: ``clause_votes`` and ``indexed_votes`` (serving),
``clause_outputs`` (the reference's learning-round kernel, which
``kernels/ops.py`` calls), ``ta_update`` and ``round_vote`` (the learning
round's two halves), and
``index_update`` (the index's event replay), whose one PyTorch body serves
both devices: the reference registers one XLA body on both of its routes
too, because the replay is scatter-bound, and no kernel exists for it, so
the CUDA route is that body by design and not a fallback.

Sharded topologies (``core/distributed.py``) call the same primitives on
each rank's clause rows. Padding rows need no kernel change: the two vote
primitives and ``round_vote`` take polarity 0 for them, ``ta_update``
takes them with ``active`` False (the clause mask), and ``clause_outputs``
is handed the rank's rows by its caller.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.kernels import clause_eval, indexed, ta_update


@dataclasses.dataclass(frozen=True)
class Primitive:
    """One TM primitive: a plain body and a CUDA kernel, routed by device."""

    name: str
    plain: Callable
    kernel: Callable

    def __call__(self, *args: torch.Tensor, **kwargs):
        """Run the body the first operand's device calls for."""
        kind = args[0].device.type
        if kind == "cuda":
            return self.kernel(*args, **kwargs)
        if kind == "cpu":
            return self.plain(*args, **kwargs)
        raise ValueError(
            f"{self.name}: no body for device {args[0].device}; "
            "'cuda' launches the kernel, 'cpu' runs the plain version")


_PRIMITIVES: dict[str, Primitive] = {}


def register_primitive(prim: Primitive) -> Primitive:
    """Add a primitive to the registry (idempotent per name)."""
    if not prim.name:
        raise ValueError("primitive must set a non-empty name")
    _PRIMITIVES[prim.name] = prim
    return prim


def get_primitive(name: str) -> Primitive:
    """Look up a registered primitive by name (KeyError lists what exists)."""
    try:
        return _PRIMITIVES[name]
    except KeyError:
        raise KeyError(
            f"unknown TM primitive {name!r}; registered: "
            f"{registered_primitives()}") from None


def registered_primitives() -> tuple[str, ...]:
    """Registered primitive names, registration order."""
    return tuple(_PRIMITIVES)


def resolve(name: str) -> Primitive:
    """Primitive name → callable that routes each call by tensor device."""
    return get_primitive(name)


# Fused eval + vote over packed include words (the bitpack engine).
register_primitive(Primitive(
    name="clause_votes",
    plain=clause_eval.clause_votes_ref,
    kernel=clause_eval.clause_votes_packed,
))

# Eq. 4 by a walk of the false literals' inclusion lists (the indexed
# engine, the default serving engine): (lists, counts, pos, lit, pol).
register_primitive(Primitive(
    name="indexed_votes",
    plain=indexed.indexed_votes_walk_ref,
    kernel=indexed.indexed_votes,
))

# Per-clause outputs of one class row (the learning round's first half).
register_primitive(Primitive(
    name="clause_outputs",
    plain=clause_eval.clause_outputs_ref,
    kernel=clause_eval.clause_outputs_packed,
))

# Type I / Type II feedback of one class round (its second half).
register_primitive(Primitive(
    name="ta_update",
    plain=ta_update.ta_update_ref,
    kernel=ta_update.ta_update,
))

# A class round's first half: (n,) int8 clause outputs and the 0-d int32
# vote of one class row, from its TA states: (ta_row, lit_words, pol).
register_primitive(Primitive(
    name="round_vote",
    plain=clause_eval.round_vote_ref,
    kernel=clause_eval.round_vote,
))

# Batched event replay into the falsification index: the same PyTorch body
# on both devices (module docstring).
register_primitive(Primitive(
    name="index_update",
    plain=indexed.index_update_batched,
    kernel=indexed.index_update_batched,
))
