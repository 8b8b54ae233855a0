"""Carry a reference-package model across to the port without importing it.

Both functions take plain Python and numpy values, so a caller holding a
``repro`` model converts with, for example::

    cfg = config_from_reference(dataclasses.asdict(jax_cfg))
    state = state_from_reference(cfg, np.asarray(jax_state.ta_state), "cuda")

Checkpoints are the other way across: ``TsetlinMachine.load`` reads a
schema-v1 checkpoint written by either package. Randomness crosses through
:func:`draws_from_reference`: the reference's draws for a batch, as numpy
arrays, become the port's ``SampleDraws``, so both packages can train on
identical uniforms.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.tm import FeedbackRands, SampleDraws
from repro_torch.core.types import TMConfig, TMState, resolve_device


def config_from_reference(jax_cfg_fields: dict) -> TMConfig:
    """``TMConfig`` from the reference config's field dict.

    ``state_dtype`` may be any numpy-compatible dtype spelling (the JAX
    scalar type, ``"int16"``); ``backend`` is a JAX execution detail and
    becomes ``'auto'``, the port's only value (the checkpoint fingerprint
    ignores it on both sides).
    """
    names = {f.name for f in dataclasses.fields(TMConfig)}
    unknown = set(jax_cfg_fields) - names
    if unknown:
        raise ValueError(f"fields the port's TMConfig lacks: {sorted(unknown)}")
    fields = dict(jax_cfg_fields)
    if "state_dtype" in fields:
        fields["state_dtype"] = getattr(torch, np.dtype(fields["state_dtype"]).name)
    fields["backend"] = "auto"
    return TMConfig(**fields)


def state_from_reference(cfg: TMConfig, ta_state: np.ndarray,
                         device) -> TMState:
    """``TMState`` on ``device`` from the reference's ``(m, n, 2o)`` TA array."""
    ta = np.asarray(ta_state)
    want = (cfg.n_classes, cfg.n_clauses, cfg.n_literals)
    if ta.shape != want:
        raise ValueError(f"ta_state shape {ta.shape} != config's {want}")
    return TMState(ta_state=torch.from_numpy(np.ascontiguousarray(ta)).to(
        device=resolve_device(device), dtype=cfg.state_dtype))


def draws_from_reference(neg_raw, target_gate, target_type_i, other_gate,
                         other_type_i, device) -> SampleDraws:
    """``SampleDraws`` on ``device`` from a batch of the reference's draws.

    ``neg_raw`` (B,) is the reference's raw negative-class draw
    (``randint(k_neg, (), 0, m-1)`` before its shift past the label); the
    ``*_gate`` (B, n) and ``*_type_i`` (B, n, 2o) arrays are its
    ``draw_feedback_rands`` for the target round (``k_a``) and the negative
    round (``k_b``).
    """
    dev = resolve_device(device)

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=dev,
                                                            dtype=dtype)

    return SampleDraws(
        neg_raw=t(neg_raw, torch.int64),
        target=FeedbackRands(t(target_gate, torch.float32),
                             t(target_type_i, torch.float32)),
        other=FeedbackRands(t(other_gate, torch.float32),
                            t(other_type_i, torch.float32)))
