"""Versioned TM checkpoints (schema v1) — port of
``repro.checkpoint.tm_store``, interchangeable with it on disk.

A schema-v1 step holds four arrays: ``schema_version``, ``fingerprint``,
``step`` and ``ta_state``. Engine caches are derived data and never persist;
restoring rebuilds them. A checkpoint is topology-free: ``ta_state`` is
always the unpadded global ``(m, n_clauses, 2o)`` state, whatever topology
wrote it, and ``TMSession.restore`` lands it on the restoring session's
placement (reshard-on-restore), caches rebuilt there and any stale-vote
accumulator at zero. The fingerprint (sha256 over the ``repr`` of every
model field of ``TMConfig``) catches a restore into a machine whose
semantics differ even where every shape matches (a changed ``s``).

Both packages must hash the same text for the same config. Every field
renders identically in both except ``state_dtype``: the reference's is a JAX
scalar type whose ``repr`` is ``<class 'jax.numpy.int16'>``, so the port
renders its ``torch.int16`` as that exact string. A checkpoint written by
either package therefore loads in the other.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core.types import resolve_device

SCHEMA_VERSION = 1
_DIGEST_BYTES = 32  # sha256

# Execution details that do not change what a checkpoint *is*.
_EXECUTION_FIELDS = frozenset({"backend"})


class CheckpointMismatch(ValueError):
    """Checkpoint incompatible with the restoring machine's config/schema."""


def _field_repr(value) -> str:
    if isinstance(value, torch.dtype):
        # the reference's spelling of the same dtype (module docstring)
        return f"<class 'jax.numpy.{str(value).removeprefix('torch.')}'>"
    return repr(value)


def config_fingerprint(cfg) -> np.ndarray:
    """(32,) uint8 sha256 over the canonical config field dump."""
    fields = {f.name: _field_repr(getattr(cfg, f.name))
              for f in dataclasses.fields(cfg)
              if f.name not in _EXECUTION_FIELDS}
    blob = json.dumps(fields, sort_keys=True).encode()
    return np.frombuffer(hashlib.sha256(blob).digest(), np.uint8).copy()


def checkpoint_tree(cfg, ta_state, *, step: int = 0) -> dict:
    """The schema-v1 payload for one TM state (a flat dict)."""
    return {
        "schema_version": np.asarray(SCHEMA_VERSION, np.int32),
        "fingerprint": config_fingerprint(cfg),
        "step": np.asarray(step, np.int32),
        "ta_state": ta_state,
    }


def validate_meta(loaded: dict, cfg, *, where: str = "checkpoint") -> None:
    """Raise ``CheckpointMismatch`` on a schema or fingerprint mismatch."""
    version = int(np.asarray(loaded["schema_version"]))
    if version != SCHEMA_VERSION:
        raise CheckpointMismatch(
            f"{where}: schema version {version} != supported "
            f"{SCHEMA_VERSION}")
    want = config_fingerprint(cfg)
    got = np.asarray(loaded["fingerprint"], np.uint8)
    if got.shape != want.shape or not np.array_equal(got, want):
        raise CheckpointMismatch(
            f"{where}: config fingerprint mismatch — the checkpoint was "
            f"written with a different TMConfig than the restoring "
            f"machine's (saved {bytes(got[:8]).hex()}…, restoring "
            f"{bytes(want[:8]).hex()}…); load with the original config")


# One Checkpointer per directory, so in-flight writes serialise and a failed
# asynchronous write surfaces on the next call.
_CHECKPOINTERS: dict[str, Checkpointer] = {}


def _checkpointer(directory, keep: int | None = None) -> Checkpointer:
    key = str(Path(directory).resolve())
    ck = _CHECKPOINTERS.get(key)
    if ck is None:
        ck = Checkpointer(directory, keep=3 if keep is None else keep)
        _CHECKPOINTERS[key] = ck
    elif keep is not None:
        ck.keep = keep
    return ck


def save_tm(directory, cfg, ta_state, *, step: int = 0, keep: int = 3,
            blocking: bool = True) -> None:
    """Write one schema-v1 checkpoint step (atomic, retained per ``keep``)."""
    _checkpointer(directory, keep=keep).save(
        step, checkpoint_tree(cfg, ta_state, step=step), blocking=blocking)


def load_tm(directory, cfg, like_ta_state, *, step: int | None = None,
            device="cuda") -> tuple[torch.Tensor, int]:
    """Restore ``(ta_state, step)`` from the newest (or given) step.

    ``like_ta_state`` supplies the expected shape (anything with ``.shape``);
    the state lands on ``device`` in ``cfg.state_dtype``: the card by
    default, as at every entry point, so without CUDA it raises unless the
    caller passes ``device="cpu"``. Meta is validated first, so a config
    mismatch surfaces as ``CheckpointMismatch``.
    """
    device = resolve_device(device)
    ckpt = _checkpointer(directory)
    ckpt.wait()  # drain any in-flight save (and surface its error) first
    if step is None:
        step = ckpt.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no committed TM checkpoint steps under {directory}")
    try:
        meta = ckpt.restore(step, ("schema_version", "fingerprint"))
    except KeyError as e:
        raise CheckpointMismatch(
            f"{directory} step {step}: not a schema-v1 TM checkpoint "
            f"(missing {e})") from None
    validate_meta(meta, cfg, where=f"{directory} step {step}")
    ta = ckpt.restore(step, ("ta_state",))["ta_state"]
    if tuple(ta.shape) != tuple(like_ta_state.shape):
        raise ValueError(f"ta_state: checkpoint shape {ta.shape} != "
                         f"{tuple(like_ta_state.shape)}")
    return torch.from_numpy(ta).to(device=device, dtype=cfg.state_dtype), step
