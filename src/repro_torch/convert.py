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

LM weights cross with :func:`lm_params_from_reference`: the reference's
param pytree, as nested dicts of numpy arrays, becomes the port's ``LM``
module (``Whisper`` for the encoder-decoder family)::

    params_np = jax.tree.map(np.asarray, jax_model.init(jax.random.key(0)))
    params = lm_params_from_reference(cfg, params_np, "cuda")

and are laid out over a mesh by the steps' ``in_specs`` with
:func:`shard_lm` (the parameters) and :func:`shard_train_state` (a
training state: parameters, moments, residuals, step); :func:`gather_lm` /
:func:`gather_train_state` assemble them again::

    params = shard_lm(lm_params_from_reference(cfg, params_np, "cpu"), mesh)
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.tm import FeedbackRands, SampleDraws
from repro_torch.core.types import TMConfig, TMState, resolve_device
from repro_torch.models.transformer import LM
from repro_torch.models.whisper import Whisper
from repro_torch.optim import adamw, compression
from repro_torch.sharding import (
    P,
    ShardedModule,
    gather,
    gather_module,
    shard,
    shard_module,
)


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


def _lm_leaves(tree, prefix: tuple = ()):
    """(path, array) for every leaf of nested dicts and lists (a list index
    becomes its decimal string, as in the port's module names)."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, val in items:
        if isinstance(val, (dict, list)):
            yield from _lm_leaves(val, prefix + (str(key),))
        else:
            yield prefix + (str(key),), val


def _lm_target(path: tuple, names) -> tuple[str, bool]:
    """The port's parameter name for a reference leaf path (with the layer
    index in place) and whether the array is transposed: a dense layer the
    port holds as an ``nn.Linear`` is ``(in, out)`` in the reference and
    ``(out, in)`` in the port; every other leaf (norm scales, the MoE's
    router and stacked experts, RWKV's mixes and LoRA factors, …) keeps the
    reference's layout."""
    *head, last = path
    if last.endswith("_bias"):                   # attn wq_bias → attn.wq.bias
        return ".".join((*head, last[:-len("_bias")], "bias")), False
    linear = ".".join((*path, "weight"))
    if linear in names:                          # wq, w_up, lm_head, …
        return linear, True
    return ".".join(path), False


_STACKED = ("layers", "enc_layers")


@torch.no_grad()
def lm_params_from_reference(cfg, params_np: dict, device) -> LM | Whisper:
    """The port's float32 ``LM`` (``Whisper`` for encdec) on ``device``
    holding the reference's weights (``cfg`` is the port's ``ModelConfig``).

    ``params_np`` is the reference's tree as nested dicts (and, for a
    hybrid's ``tail``, a list) of arrays: layers stacked ``(L, …)`` under
    ``layers/b{i}_{kind}``, ``embed/tokens``, ``final_norm``, ``tail/{i}``
    and, untied, ``lm_head``; whisper's under ``enc_layers/…`` and
    ``layers/…`` (stacked), ``enc_norm``, ``pos_embed`` (its rows set the
    module's ``max_dec_positions``) and the padded ``embed/tokens``. Any
    float dtype is taken through float32 (exact for bf16); cast the result
    with ``.to`` for bf16 serving. Every leaf lands in exactly one
    parameter and every parameter is filled, or this raises ``ValueError``.
    """
    dev = resolve_device(device)
    if cfg.family == "encdec":
        pos = params_np.get("pos_embed")
        params = Whisper(cfg, dev, max_dec_positions=(
            4096 if pos is None else np.shape(pos)[0]))
    else:
        params = LM(cfg, dev)
    left = dict(params.named_parameters())
    names = set(left)
    for path, arr in _lm_leaves(params_np):
        arr = np.array(arr, dtype=np.float32)    # a writable copy
        if path[0] in _STACKED:                  # ("layers", key, …) stacked
            targets = [(_lm_target((path[0], str(j)) + path[1:], names), arr[j])
                       for j in range(arr.shape[0])]
        else:
            targets = [(_lm_target(path, names), arr)]
        for (name, transpose), a in targets:
            if name not in left:
                raise ValueError(f"reference leaf {'/'.join(path)} has no "
                                 f"port parameter {name!r} (or fills it twice)")
            t = torch.from_numpy(np.ascontiguousarray(a.T if transpose else a))
            if t.shape != left[name].shape:
                raise ValueError(f"{'/'.join(path)} → {name}: shape "
                                 f"{tuple(t.shape)} != {tuple(left[name].shape)}")
            left.pop(name).copy_(t)
    if left:
        raise ValueError(f"port parameters with no reference leaf: {sorted(left)}")
    return params


def shard_lm(params: LM | Whisper, mesh, *, consume: bool = False) -> ShardedModule:
    """``params`` laid out over ``mesh`` by ``sharding.param_specs`` (the
    steps' ``in_specs``); ``consume=True`` frees each parameter once it
    is sharded."""
    return shard_module(params, mesh, consume=consume)


def gather_lm(params: ShardedModule, device=None) -> LM | Whisper:
    """The whole module of a ``shard_lm`` layout, on ``device`` (rank 0's
    by default)."""
    return gather_module(params, device)


@torch.no_grad()
def shard_train_state(state: dict, mesh) -> dict:
    """A ``steps.init_train_state`` state laid out over ``mesh`` as
    ``make_train_step(…, mesh).in_specs[0]`` says: the parameters by
    ``shard_lm``, the moments and residuals like them, the step on every
    rank."""
    params = shard_lm(state["params"], mesh)
    specs = params.specs

    def like_params(tree):
        return {n: shard(t, specs[n], mesh, n) for n, t in tree.items()}

    opt = state["opt"]
    return {"params": params,
            "opt": adamw.AdamWState(shard(opt.step, P(), mesh),
                                    like_params(opt.mu), like_params(opt.nu)),
            "ef": compression.ErrorFeedback(like_params(state["ef"].residual))}


def gather_train_state(state: dict, device=None) -> dict:
    """The whole train state of a ``shard_train_state`` layout."""
    params = gather_lm(state["params"], device)
    specs, mesh = state["params"].specs, state["params"].mesh

    def whole(tree):
        return {n: gather(xs, specs[n], mesh, device) for n, xs in tree.items()}

    opt = state["opt"]
    return {"params": params,
            "opt": adamw.AdamWState(gather(opt.step, P(), mesh, device),
                                    whole(opt.mu), whole(opt.nu)),
            "ef": compression.ErrorFeedback(whole(state["ef"].residual))}
