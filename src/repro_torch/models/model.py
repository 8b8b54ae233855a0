"""Uniform model facade (the port's ``repro.models.model``).

  build(cfg)  → Model with init / apply_train / prefill / decode_step /
                init_cache
  input_shapes(cfg, shape, …) → a shape cell's inputs as (shape, dtype)
  input_specs(cfg, shape, …) → zero tensors of a shape cell's inputs
  cache_specs(cfg, shape, …) → the decode cache's shapes and dtypes

Every family runs: dense, moe, vlm, ssm and hybrid through
``models/transformer.py``, encdec (whisper) through ``models/whisper.py``,
whose batches carry ``frames`` (B, enc_seq, d).

``apply_train`` / ``prefill`` / ``decode_step`` take ``policy=``: with an
active ``sharding.Policy`` the params are a ``ShardedModule`` (or its
per-rank views), the inputs ``PerRank`` lists, and the call runs the
family's sharded functions on the policy's mesh (every family has them).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core.types import resolve_device
from repro_torch.models import attention, transformer, whisper

COMPUTE_DTYPE = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class Model:
    """One config's functions; ``params`` is the ``LM`` (or, for encdec,
    ``Whisper``) module ``init`` returns (or
    ``convert.lm_params_from_reference`` builds)."""

    cfg: ModelConfig
    init: Callable          # (generator) -> params (float32, on its device)
    apply_train: Callable   # (params, *, policy=None, **batch) -> (logits, aux)
    prefill: Callable       # (params, cache_len, *, policy=None, **batch) -> …
    decode_step: Callable   # (params, token, caches, pos, policy=None) -> …
    init_cache: Callable    # (batch, cache_len, device="cuda") -> cache


def _sharded(policy) -> bool:
    return policy is not None and policy.active


def build(cfg: ModelConfig) -> Model:
    """The facade of ``cfg``. For encdec, ``init`` takes
    ``max_dec_positions`` (default 4096) and the batches carry ``frames``."""
    if cfg.family == "encdec":
        def init(generator: torch.Generator, max_dec_positions=4096):
            return whisper.init_params(generator, cfg, max_dec_positions)

        def apply_train(params, *, tokens, frames, policy=None):
            if _sharded(policy):
                return whisper.apply_train_sharded(cfg, policy, params, tokens,
                                                   frames)
            return whisper.apply_train(cfg, params, tokens, frames)

        def prefill_fn(params, cache_len, *, tokens, frames, policy=None):
            if _sharded(policy):
                return whisper.prefill_sharded(cfg, policy, params, tokens,
                                               frames, cache_len)
            return whisper.prefill(cfg, params, tokens, frames, cache_len)

        def decode_fn(params, token, caches, pos, policy=None):
            if _sharded(policy):
                return whisper.decode_step_sharded(cfg, policy, params, token,
                                                   caches, pos)
            return whisper.decode_step(cfg, params, token, caches, pos)

        def init_cache(batch, cache_len, device="cuda"):
            return whisper.init_dec_cache(cfg, batch, cache_len, cfg.enc_seq,
                                          device=device)

        return Model(cfg, init, apply_train, prefill_fn, decode_fn,
                     init_cache)
    transformer._plan(cfg)

    def init(generator: torch.Generator):
        return transformer.init_params(generator, cfg)

    def apply_train(params, *, tokens, vision_embeds=None, policy=None):
        if _sharded(policy):
            return transformer.apply_train_sharded(cfg, policy, params, tokens,
                                                   vision_embeds)
        return transformer.apply_train(cfg, params, tokens, vision_embeds)

    def prefill_fn(params, cache_len, *, tokens, vision_embeds=None,
                   policy=None):
        if _sharded(policy):
            return transformer.prefill_sharded(cfg, policy, params, tokens,
                                               cache_len, vision_embeds)
        return transformer.prefill(cfg, params, tokens, cache_len,
                                   vision_embeds)

    def decode_fn(params, token, caches, pos, policy=None):
        if _sharded(policy):
            return transformer.decode_step_sharded(cfg, policy, params, token,
                                                   caches, pos)
        return transformer.decode_step(cfg, params, token, caches, pos)

    def init_cache(batch, cache_len, device="cuda"):
        return transformer.init_cache(cfg, batch, cache_len, device=device)

    return Model(cfg, init, apply_train, prefill_fn, decode_fn, init_cache)


# ---------------------------------------------------------------------------
# Inputs and caches per shape cell
# ---------------------------------------------------------------------------


def input_shapes(cfg: ModelConfig, shape: ShapeSpec, *,
                 batch_override: Optional[int] = None,
                 seq_override: Optional[int] = None) -> dict[str, tuple]:
    """One cell's model inputs as ``{name: (shape, dtype)}``, allocating
    nothing (the reference's ``input_specs`` structs).

    train/prefill: full-sequence inputs (+labels for train).
    decode: single token + positions; the cache comes from ``cache_specs``.
    """
    b = batch_override or shape.global_batch
    s = seq_override or shape.seq_len
    if shape.kind in ("train", "prefill"):
        if cfg.family == "vlm":
            s_text = s - cfg.n_vision_tokens
            if s_text <= 0:
                raise ValueError("shape too small for vision tokens")
            batch = {
                "tokens": ((b, s_text), torch.int32),
                "vision_embeds": ((b, cfg.n_vision_tokens, cfg.d_model),
                                  COMPUTE_DTYPE),
            }
        elif cfg.family == "encdec":
            batch = {
                "tokens": ((b, s), torch.int32),
                "frames": ((b, cfg.enc_seq, cfg.d_model), COMPUTE_DTYPE),
            }
        else:
            batch = {"tokens": ((b, s), torch.int32)}
        if shape.kind == "train":
            batch["labels"] = (
                (b, s if cfg.family != "vlm" else s - cfg.n_vision_tokens),
                torch.int32)
        return batch
    if shape.kind == "decode":
        return {"token": ((b, 1), torch.int32), "pos": ((b,), torch.int32)}
    raise ValueError(shape.kind)


def input_specs(cfg: ModelConfig, shape: ShapeSpec, *,
                batch_override: Optional[int] = None,
                seq_override: Optional[int] = None,
                device="cuda") -> dict[str, Any]:
    """Zero tensors of one cell's model inputs on ``device`` (the shapes
    and dtypes of ``input_shapes``)."""
    dev = resolve_device(device)
    return {name: torch.zeros(shp, dtype=dt, device=dev)
            for name, (shp, dt) in input_shapes(
                cfg, shape, batch_override=batch_override,
                seq_override=seq_override).items()}


def effective_cache_len(cfg: ModelConfig, shape: ShapeSpec) -> int:
    """Rolling-buffer truncation for windowed archs."""
    window = attention.gqa_kw(cfg)["window"]
    return min(shape.seq_len, window) if window else shape.seq_len


def cache_specs(cfg: ModelConfig, shape: ShapeSpec,
                batch_override: Optional[int] = None) -> dict:
    """The decode cache as nested dicts of ``(shape, dtype)`` (the
    reference's ``eval_shape`` of ``init_cache``: bf16 K/V and token
    shifts, float32 recurrent states, whisper's cross K/V in its compute
    dtype), allocating nothing."""
    b = batch_override or shape.global_batch
    clen = effective_cache_len(cfg, shape)
    if cfg.family == "encdec":
        return whisper.cache_shapes(cfg, b, clen, cfg.enc_seq)
    return transformer.cache_shapes(cfg, b, clen)
