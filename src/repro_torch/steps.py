"""Train / prefill / decode step factories (the port's ``repro.steps``), on
one device.

``make_*_step`` return a ``StepBuild``: the step function plus the
``(shape, dtype)`` trees of its arguments (``arg_structs``: what
``model.input_shapes`` / ``model.cache_specs`` give and the state's
parameters, moments and residuals), the loop trip counts and metadata. The
reference's ``in_specs`` / ``out_specs`` are PartitionSpecs for a device
mesh; they come with the sharded LM path, so a ``mesh`` raises here.

Training, in the reference's order: the batch is split into M microbatches
(``reshape((M, B/M) + …)``); each runs forward in bf16 from the float32
masters (every parameter cast with autograd through the cast, so the
gradients arrive in float32 on the masters), adds ``aux_coef·aux`` (the
MoE load-balance loss), drops a VLM's vision positions, and backward
accumulates float32 gradients; then the sum is divided by M, compressed
(``optim.compression``, error feedback), the learning rate is taken from
``opt.step`` before its increment, and ``optim.adamw.update`` writes the
parameters in place. The state is ``{"params": LM or Whisper (float32),
"opt": AdamWState, "ef": ErrorFeedback}``; the step updates it in place
and returns ``(state, metrics)``, metrics ``loss`` / ``nll`` (means over
the microbatches), ``grad_norm`` and ``lr``. ``train_state_to_ckpt`` /
``train_state_from_ckpt`` are the ``Trainer``'s checkpoint views of it.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Callable

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models.model import (
    Model,
    build,
    cache_specs,
    effective_cache_len,
    input_shapes,
)
from repro_torch.models.transformer import LM
from repro_torch.models.whisper import Whisper
from repro_torch.optim import adamw, compression
from repro_torch.optim import schedule as sched

COMPUTE_DTYPE = torch.bfloat16


@dataclasses.dataclass
class StepBuild:
    """A step function and what describes it. ``arg_structs``: its
    positional arguments as ``(shape, dtype)`` trees. The reference's
    ``in_specs`` / ``out_specs`` (PartitionSpecs) belong to the sharded LM
    path and are left out."""

    fn: Callable
    arg_structs: tuple
    loop_dims: dict          # name -> full trip count
    meta: dict


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "the port's LM steps run on one device; the sharded LM path "
            "(PartitionSpecs, Policy.for_mesh) is not ported")


def batch_axes_for(global_batch: int, mesh) -> tuple:
    """The mesh axes the batch is sharded over: ``()`` without a mesh."""
    _no_mesh(mesh)
    return ()


def _xent(logits, labels):
    """Stable token cross-entropy plus the ``1e-4·lse²`` z-loss; logits
    (B, S, V) float32. Returns (nll + z-loss, nll)."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = (lse - gold).mean()
    z_loss = 1e-4 * torch.square(lse).mean()
    return nll + z_loss, nll


def _cast_view(module: nn.Module, dtype) -> nn.Module:
    """A shallow copy of ``module``'s tree whose float32 parameters are
    ``p.to(dtype)``: differentiable casts of the masters, so a backward
    pass through the view puts float32 gradients on the masters (the
    reference's ``astype`` of every float32 leaf inside the loss). The
    view outlives the forward pass, so recomputing a block in the backward
    (remat) sees the same casts."""
    view = copy.copy(module)
    view.__dict__["_parameters"] = {
        n: (p.to(dtype) if p is not None and p.dtype == torch.float32 else p)
        for n, p in module._parameters.items()}
    view.__dict__["_modules"] = {
        n: (None if m is None else _cast_view(m, dtype))
        for n, m in module._modules.items()}
    return view


# ---------------------------------------------------------------------------
# Structures (shape, dtype), allocating nothing
# ---------------------------------------------------------------------------


def _init_for(model: Model, cfg: ModelConfig, gen: torch.Generator,
              max_positions=None):
    """``model.init(gen)``; encdec with ``max_positions`` decoder positions
    (default 4096)."""
    if cfg.family == "encdec":
        return model.init(gen, max_positions or 4096)
    return model.init(gen)


def _param_structs(cfg: ModelConfig, dtype=torch.float32,
                   max_positions=None) -> dict:
    """``{name: (shape, dtype)}`` of the model's parameters, from a module
    built on the meta device."""
    meta = torch.device("meta")
    if cfg.family == "encdec":
        params = Whisper(cfg, meta, max_dec_positions=max_positions or 4096)
    else:
        params = LM(cfg, meta)
    return {n: (tuple(p.shape), dtype) for n, p in params.named_parameters()}


def _layer_count(cfg: ModelConfig) -> int:
    """Trip count of the layer loop: pattern groups for a hybrid."""
    if cfg.family == "hybrid":
        pat = cfg.pattern or ("rec", "rec", "attn")
        return cfg.n_layers // len(pat)
    return cfg.n_layers


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


def make_train_step(
    cfg: ModelConfig,
    shape: ShapeSpec,
    mesh=None,
    *,
    microbatches: int = 8,
    compress: str = "none",
    peak_lr: float = 3e-4,
    warmup_steps: int = 200,
    total_steps: int = 10_000,
    aux_coef: float = 0.01,
) -> StepBuild:
    """The training step of ``cfg`` at ``shape`` (see the module's
    docstring); ``shape.global_batch`` must be a multiple of
    ``microbatches``."""
    _no_mesh(mesh)
    model = build(cfg)

    def loss_fn(params, mb):
        labels = mb.pop("labels")
        logits, aux = model.apply_train(params, **mb)
        if cfg.family == "vlm":
            logits = logits[:, cfg.n_vision_tokens:]
        loss, nll = _xent(logits, labels)
        return loss + aux_coef * aux, nll

    def train_step(state, batch):
        params, opt, ef = state["params"], state["opt"], state["ef"]
        named = dict(params.named_parameters())
        mbs = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                            + tuple(v.shape[1:])) for k, v in batch.items()}
        for p in named.values():
            p.grad = None
        losses, nlls = [], []
        with torch.enable_grad():
            for i in range(microbatches):
                loss, nll = loss_fn(_cast_view(params, COMPUTE_DTYPE),
                                    {k: v[i] for k, v in mbs.items()})
                loss.backward()        # accumulates float32 into .grad
                losses.append(loss.detach())
                nlls.append(nll.detach())
        grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad)
                 for n, p in named.items()}
        for p in named.values():
            p.grad = None
        torch._foreach_div_(list(grads.values()), microbatches)
        grads, ef = compression.compress_grads(grads, ef, mode=compress)
        lr = sched.cosine_with_warmup(
            opt.step, peak_lr=peak_lr, warmup_steps=warmup_steps,
            total_steps=total_steps)
        opt, metrics = adamw.update(grads, opt, named, lr=lr)
        metrics.update(loss=torch.stack(losses).mean(),
                       nll=torch.stack(nlls).mean())
        return {"params": params, "opt": opt, "ef": ef}, metrics

    params_s = _param_structs(cfg)
    state_struct = {
        "params": params_s,
        "opt": adamw.AdamWState(step=((), torch.int32), mu=params_s,
                                nu=params_s),
        "ef": compression.ErrorFeedback(residual=params_s),
    }
    loop_dims = {"microbatches": microbatches, "layers": _layer_count(cfg)}
    if cfg.family == "encdec":
        loop_dims["enc_layers"] = cfg.n_enc_layers
    return StepBuild(
        fn=train_step,
        arg_structs=(state_struct, input_shapes(cfg, shape)),
        loop_dims=loop_dims,
        meta=dict(kind="train", microbatches=microbatches),
    )


def init_train_state(params: nn.Module) -> dict:
    """``{"params", "opt", "ef"}`` for float32 ``params``: zero moments and
    zero residuals (float32, in every compression mode)."""
    return {"params": params, "opt": adamw.init(params),
            "ef": compression.init_error_feedback(params)}


def train_state_to_ckpt(state: dict) -> dict:
    """The ``Trainer``'s checkpoint view of a train state: one flat dict of
    tensors, ``params/<name>``, ``mu/<name>``, ``nu/<name>``, ``ef/<name>``
    (float32) and ``step`` (int32). No copy is made here: ``Checkpointer.save``
    takes its own snapshot."""
    out = {f"params/{n}": p.detach()
           for n, p in state["params"].named_parameters()}
    for part, tree in (("mu", state["opt"].mu), ("nu", state["opt"].nu),
                       ("ef", state["ef"].residual)):
        out.update({f"{part}/{n}": t for n, t in tree.items()})
    out["step"] = state["opt"].step
    return out


@torch.no_grad()
def train_state_from_ckpt(loaded: dict, state: dict) -> dict:
    """Copy a restored ``train_state_to_ckpt`` view (numpy arrays) into
    ``state``'s tensors in place; returns ``state`` with the restored
    step."""
    for key, t in train_state_to_ckpt(state).items():
        if key != "step":
            t.copy_(torch.from_numpy(np.asarray(loaded[key])))
    step = torch.as_tensor(np.asarray(loaded["step"]), dtype=torch.int32,
                           device=state["opt"].step.device)
    state["opt"] = state["opt"]._replace(step=step)
    return state


# ---------------------------------------------------------------------------
# Prefill / decode steps (serving)
# ---------------------------------------------------------------------------


def _serve_params_struct(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Serving params: bf16 everywhere (the float32 masters live in
    training); whisper's positions cover ``max(seq_len, 4096)``."""
    max_pos = max(shape.seq_len, 4096) if cfg.family == "encdec" else None
    return _param_structs(cfg, COMPUTE_DTYPE, max_pos)


def make_prefill_step(cfg: ModelConfig, shape: ShapeSpec, mesh=None) -> StepBuild:
    """``fn(params, batch) -> (last logits, cache)`` at ``shape``'s cache
    length (rolling for windowed archs)."""
    _no_mesh(mesh)
    model = build(cfg)
    clen = effective_cache_len(cfg, shape)

    def prefill_step(params, batch):
        return model.prefill(params, clen, **batch)

    loop_dims = {"layers": _layer_count(cfg)}
    if cfg.family == "encdec":
        loop_dims["enc_layers"] = cfg.n_enc_layers
    return StepBuild(
        fn=prefill_step,
        arg_structs=(_serve_params_struct(cfg, shape), input_shapes(cfg, shape)),
        loop_dims=loop_dims,
        meta=dict(kind="prefill", cache_len=clen),
    )


def make_decode_step(cfg: ModelConfig, shape: ShapeSpec, mesh=None) -> StepBuild:
    """``fn(params, caches, token, pos) -> (logits, caches)``, the cache
    updated in place."""
    _no_mesh(mesh)
    model = build(cfg)

    def decode_fn(params, caches, token, pos):
        return model.decode_step(params, token, caches, pos)

    io = input_shapes(cfg, shape)
    return StepBuild(
        fn=decode_fn,
        arg_structs=(_serve_params_struct(cfg, shape), cache_specs(cfg, shape),
                     io["token"], io["pos"]),
        loop_dims={"layers": _layer_count(cfg)},
        meta=dict(kind="decode", cache_len=effective_cache_len(cfg, shape)),
    )


def make_step(cfg: ModelConfig, shape: ShapeSpec, mesh=None, **kw) -> StepBuild:
    """The step of ``shape.kind``: train (taking ``make_train_step``'s
    keywords), prefill or decode."""
    if shape.kind == "train":
        return make_train_step(cfg, shape, mesh, **kw)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, shape, mesh)
    if shape.kind == "decode":
        return make_decode_step(cfg, shape, mesh)
    raise ValueError(shape.kind)
