"""Train / prefill / decode step factories (the port's ``repro.steps``), on
one device or a mesh.

``make_*_step`` return a ``StepBuild``: the step function plus the
``(shape, dtype)`` trees of its arguments (``arg_structs``: what
``model.input_shapes`` / ``model.cache_specs`` give and the state's
parameters, moments and residuals), the partition specs of its inputs and
outputs (``in_specs`` / ``out_specs``, the reference's, parameters keyed
by the port's names), the loop trip counts and metadata.

With a ``mesh`` (a ``launch.mesh.DeviceMesh``) the step runs sharded,
single-controller: every input and output is laid out per rank as
``in_specs`` / ``out_specs`` say (``sharding.shard_tree``; the parameters
a ``sharding.ShardedModule``, ``convert.shard_lm``), and the policy is
the reference's (``seq_shard_residual=cfg.sp_residual`` in training,
``decode_mode`` in decode). Training re-splits each microbatch on its
batch axes, takes the cross-entropy over vocabulary-split logits
(``_xent_sharded``), sums the gradients of replicated shards over their
replica axes (what the reference's partitioner does), compresses (int8's
scale the max over a tensor's shards) and clips by the global norm
counting every element once. Every family runs on a mesh; whisper's
batches carry ``frames`` (B, enc_seq, d), laid out on the batch axes like
the tokens.

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
from repro_torch.launch.mesh import axis_index, axis_size
from repro_torch.models import attention, transformer
from repro_torch.models.transformer import LM
from repro_torch.models.whisper import Whisper
from repro_torch.optim import adamw, compression
from repro_torch.optim import schedule as sched
from repro_torch.spans import span
from repro_torch.sharding import (
    DATA,
    MODEL,
    POD,
    P,
    PerRank,
    Policy,
    ShardedModule,
    all_gather,
    cache_partition_specs,
    module_view,
    param_specs,
    pmax,
    pmean,
    psum,
    replica_axes,
)

COMPUTE_DTYPE = torch.bfloat16


@dataclasses.dataclass
class StepBuild:
    """A step function and what describes it. ``arg_structs``: its
    positional arguments as ``(shape, dtype)`` trees; ``in_specs`` /
    ``out_specs``: their partition specs (``sharding.P``), the parameters'
    as ``{port name: P}``."""

    fn: Callable
    arg_structs: tuple
    in_specs: tuple
    out_specs: object
    loop_dims: dict          # name -> full trip count
    meta: dict


def batch_axes_for(global_batch: int, mesh) -> tuple:
    """Largest batch-sharding axis set the batch size divides (``()``
    without a mesh)."""
    if mesh is None:
        return ()
    axes = [a for a in (POD, DATA) if a in mesh.axis_names]
    prod = 1
    chosen = []
    for a in axes:
        if global_batch % (prod * axis_size(mesh, a)) == 0:
            chosen.append(a)
            prod *= axis_size(mesh, a)
    return tuple(chosen)


def _batch_spec(batch_tree, baxes):
    return {k: P(baxes) for k in batch_tree}


def _xent(logits, labels):
    """Stable token cross-entropy plus the ``1e-4·lse²`` z-loss; logits
    (B, S, V) float32. Returns (nll + z-loss, nll)."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = (lse - gold).mean()
    z_loss = 1e-4 * torch.square(lse).mean()
    return nll + z_loss, nll


def _xent_sharded(logits, labels, policy: Policy):
    """``_xent`` over vocabulary-split logits (per rank (B, S, V/|model|)
    float32, labels per rank): a global logsumexp through a ``pmax`` of
    the (constant) maxima and a ``psum`` of the exponentials; the gold
    logit by a masked gather on the rank that holds it and a ``psum``;
    means over the batch axes by ``pmean``. Returns per-rank (loss, nll),
    the same on every rank."""
    mesh = policy.mesh
    m_g = pmax([l.detach().amax(-1) for l in logits], mesh, MODEL)
    sums = psum([torch.exp(l - m[..., None]).sum(-1)
                 for l, m in zip(logits, m_g)], mesh, MODEL)
    lse = [torch.log(s) + m for s, m in zip(sums, m_g)]
    golds = []
    for r, (l, lab) in enumerate(zip(logits, labels)):
        vm = l.shape[-1]
        local = lab.long() - axis_index(mesh, r, MODEL) * vm
        ok = (local >= 0) & (local < vm)
        g = torch.gather(l, -1, local.clamp(0, vm - 1)[..., None])[..., 0]
        golds.append(torch.where(ok, g, 0.0))
    gold = psum(golds, mesh, MODEL)
    nll = pmean([(a - g).mean() for a, g in zip(lse, gold)], mesh,
                policy.batch_axes)
    z = pmean([1e-4 * torch.square(a).mean() for a in lse], mesh,
              policy.batch_axes)
    return PerRank(n + zz for n, zz in zip(nll, z)), nll


def train_loss(cfg: ModelConfig, params, mb: dict, *, aux_coef: float = 0.01,
               model: Model | None = None):
    """One microbatch's training loss on one device, as the train step takes
    it: the forward pass on a bf16 view of the float32 masters ``params``
    (autograd through the casts), the cross-entropy with its z-loss, plus
    ``aux_coef·aux``. ``mb``: ``tokens``, ``labels`` (and a VLM's
    ``vision_embeds``). Returns ``(loss, nll, logits)``, the logits (B, S,
    V) float32 of the text positions."""
    model = build(cfg) if model is None else model
    mb = dict(mb)
    labels = mb.pop("labels")
    logits, aux = model.apply_train(_cast_view(params, COMPUTE_DTYPE), **mb)
    if cfg.family == "vlm":
        logits = logits[:, cfg.n_vision_tokens:]
    with span("lm.head_loss"):
        loss, nll = _xent(logits, labels)
    return loss + aux_coef * aux, nll, logits


def _cast_view(module: nn.Module, dtype) -> nn.Module:
    """A shallow copy of ``module``'s tree whose float32 parameters are
    ``p.to(dtype)`` (``sharding.module_view``): differentiable casts of the
    masters, so a backward pass through the view puts float32 gradients on
    the masters (the reference's ``astype`` of every float32 leaf inside
    the loss). The view outlives the forward pass, so recomputing a block
    in the backward (remat) sees the same casts."""
    return module_view(module, {}, dtype=dtype)


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


def _meta_module(cfg: ModelConfig, max_positions=None) -> nn.Module:
    """The model's module on the meta device (allocating nothing)."""
    meta = torch.device("meta")
    if cfg.family == "encdec":
        return Whisper(cfg, meta, max_dec_positions=max_positions or 4096)
    return LM(cfg, meta)


def _param_structs(cfg: ModelConfig, dtype=torch.float32,
                   max_positions=None) -> dict:
    """``{name: (shape, dtype)}`` of the model's parameters, from a module
    built on the meta device."""
    return {n: (tuple(p.shape), dtype) for n, p in
            _meta_module(cfg, max_positions).named_parameters()}


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
    ``microbatches``. With a ``mesh`` the step is sharded."""
    model = build(cfg)
    baxes = batch_axes_for(shape.global_batch // microbatches, mesh)
    policy = Policy.none()
    if mesh is not None:
        attention.check_mesh(cfg)
        policy = dataclasses.replace(Policy.for_mesh(mesh), batch_axes=baxes,
                                     seq_shard_residual=cfg.sp_residual)
    full_axes = batch_axes_for(shape.global_batch, mesh)

    def sharded_loss(params, mb):
        labels = mb.pop("labels")
        logits, aux = model.apply_train(params, policy=policy, **mb)
        if cfg.family == "vlm":
            logits = [l[:, cfg.n_vision_tokens:] for l in logits]
        loss, nll = _xent_sharded(logits, labels, policy)
        # rank 0's copy: every rank's work reaches it through the
        # reductions, and counting one copy keeps the loss the global one
        return loss[0] + aux_coef * aux[0], nll[0]

    def train_step(state, batch):
        with span("lm.train_step"):
            return _train_step(state, batch)

    def _train_step(state, batch):
        params, opt, ef = state["params"], state["opt"], state["ef"]
        named = dict(params.named_parameters())
        mbs = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                            + tuple(v.shape[1:])) for k, v in batch.items()}
        for p in named.values():
            p.grad = None
        losses, nlls = [], []
        with torch.enable_grad():
            for i in range(microbatches):
                with span("lm.microbatch"):
                    loss, nll, _ = train_loss(
                        cfg, params, {k: v[i] for k, v in mbs.items()},
                        aux_coef=aux_coef, model=model)
                    loss.backward()    # accumulates float32 into .grad
                losses.append(loss.detach())
                nlls.append(nll.detach())
        with span("lm.optimizer"):
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

    def microbatch(batch, i):
        """Microbatch ``i`` of a batch laid out on ``full_axes``, re-split
        on the microbatch's batch axes (an all-gather of the rows)."""
        out = {}
        for k, xs in batch.items():
            xs = all_gather(xs, mesh, full_axes, 0) if full_axes else xs
            n = axis_size(mesh, baxes)
            out[k] = PerRank(
                x.reshape((microbatches, x.shape[0] // microbatches)
                          + tuple(x.shape[1:]))[i].chunk(n)[
                              axis_index(mesh, r, baxes)]
                for r, x in enumerate(xs))
        return out

    def sharded_train_step(state, batch):
        params, opt, ef = state["params"], state["opt"], state["ef"]
        shards = params.shards
        for xs in shards.values():
            for p in xs:
                p.grad = None
        losses, nlls = [], []
        with torch.enable_grad():
            for i in range(microbatches):
                views = transformer.rank_views(params, COMPUTE_DTYPE)
                loss, nll = sharded_loss(views, microbatch(batch, i))
                loss.backward()        # accumulates float32 into .grad
                losses.append(loss.detach())
                nlls.append(nll.detach())
        grads = {}
        for n, xs in shards.items():
            g = PerRank(torch.zeros_like(p) if p.grad is None else p.grad
                        for p in xs)
            # a replicated shard's copies each saw part of the work: the
            # gradient of the tensor is their sum (the reference's
            # partitioner inserts the same all-reduce)
            rep = tuple(a for a in replica_axes(params.specs[n], mesh)
                        if axis_size(mesh, a) > 1)
            grads[n] = psum(g, mesh, rep) if rep else g
            for p in xs:
                p.grad = None
        torch._foreach_div_([t for g in grads.values() for t in g],
                            microbatches)
        grads, ef = compression.compress_grads_sharded(
            grads, ef, params.specs, mesh, mode=compress)
        gnorm = adamw.global_norm_sharded(grads, params.specs, mesh)
        steps_, metrics = PerRank(), None
        for r in range(mesh.size):
            lr = sched.cosine_with_warmup(
                opt.step[r], peak_lr=peak_lr, warmup_steps=warmup_steps,
                total_steps=total_steps)
            st, met = adamw.update(
                {n: g[r] for n, g in grads.items()},
                adamw.AdamWState(opt.step[r],
                                 {n: t[r] for n, t in opt.mu.items()},
                                 {n: t[r] for n, t in opt.nu.items()}),
                params.rank_parameters(r), lr=lr, gnorm=gnorm[r])
            steps_.append(st.step)
            if r == 0:
                metrics = met
        opt = adamw.AdamWState(steps_, opt.mu, opt.nu)
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
    batch_structs = input_shapes(cfg, shape)
    p_specs = param_specs(_meta_module(cfg))
    state_specs = {
        "params": p_specs,
        "opt": adamw.AdamWState(step=P(), mu=p_specs, nu=p_specs),
        "ef": compression.ErrorFeedback(residual=p_specs),
    }
    loop_dims = {"microbatches": microbatches, "layers": _layer_count(cfg)}
    if cfg.family == "encdec":
        loop_dims["enc_layers"] = cfg.n_enc_layers
    return StepBuild(
        fn=train_step if mesh is None else sharded_train_step,
        arg_structs=(state_struct, batch_structs),
        in_specs=(state_specs, _batch_spec(batch_structs, full_axes)),
        out_specs=(state_specs, P()),
        loop_dims=loop_dims,
        meta=dict(kind="train", microbatches=microbatches),
    )


def init_train_state(params) -> dict:
    """``{"params", "opt", "ef"}`` for float32 ``params``: zero moments and
    zero residuals (float32, in every compression mode). For a
    ``ShardedModule`` they are sharded like the parameters and the step
    is on every rank (``make_train_step(…, mesh).in_specs[0]``'s layout)."""
    if isinstance(params, ShardedModule):
        def zeros():
            return {n: PerRank(torch.zeros(t.shape, dtype=torch.float32,
                                           device=t.device) for t in xs)
                    for n, xs in params.shards.items()}
        step = PerRank(torch.zeros((), dtype=torch.int32, device=dev)
                       for dev in params.mesh.devices)
        return {"params": params, "opt": adamw.AdamWState(step, zeros(), zeros()),
                "ef": compression.ErrorFeedback(zeros())}
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


def _serve_policy(cfg: ModelConfig, shape: ShapeSpec, mesh, **kw):
    baxes = batch_axes_for(shape.global_batch, mesh)
    if mesh is None:
        return Policy.none(), baxes
    attention.check_mesh(cfg)
    return dataclasses.replace(Policy.for_mesh(mesh), batch_axes=baxes,
                               **kw), baxes


def make_prefill_step(cfg: ModelConfig, shape: ShapeSpec, mesh=None) -> StepBuild:
    """``fn(params, batch) -> (last logits, cache)`` at ``shape``'s cache
    length (rolling for windowed archs); sharded with a ``mesh``."""
    model = build(cfg)
    clen = effective_cache_len(cfg, shape)
    policy, baxes = _serve_policy(cfg, shape, mesh)

    def prefill_step(params, batch):
        if policy.active:
            return model.prefill(params, clen, policy=policy, **batch)
        return model.prefill(params, clen, **batch)

    params_s = _serve_params_struct(cfg, shape)
    batch_structs = input_shapes(cfg, shape)
    max_pos = max(shape.seq_len, 4096) if cfg.family == "encdec" else None
    p_specs = param_specs(_meta_module(cfg, max_pos))
    cache_p = cache_partition_specs(cache_specs(cfg, shape), policy)
    loop_dims = {"layers": _layer_count(cfg)}
    if cfg.family == "encdec":
        loop_dims["enc_layers"] = cfg.n_enc_layers
    return StepBuild(
        fn=prefill_step,
        arg_structs=(params_s, batch_structs),
        in_specs=(p_specs, _batch_spec(batch_structs, baxes)),
        out_specs=(P(baxes) if baxes else P(), cache_p),
        loop_dims=loop_dims,
        meta=dict(kind="prefill", cache_len=clen),
    )


def make_decode_step(cfg: ModelConfig, shape: ShapeSpec, mesh=None) -> StepBuild:
    """``fn(params, caches, token, pos) -> (logits, caches)``, the cache
    updated in place; sharded with a ``mesh``."""
    model = build(cfg)
    policy, baxes = _serve_policy(cfg, shape, mesh, decode_mode=True)

    def decode_fn(params, caches, token, pos):
        if policy.active:
            return model.decode_step(params, token, caches, pos, policy=policy)
        return model.decode_step(params, token, caches, pos)

    io = input_shapes(cfg, shape)
    cache_s = cache_specs(cfg, shape)
    max_pos = max(shape.seq_len, 4096) if cfg.family == "encdec" else None
    p_specs = param_specs(_meta_module(cfg, max_pos))
    cache_p = cache_partition_specs(cache_s, policy)
    bspec = P(baxes) if baxes else P()
    return StepBuild(
        fn=decode_fn,
        arg_structs=(_serve_params_struct(cfg, shape), cache_s,
                     io["token"], io["pos"]),
        in_specs=(p_specs, cache_p, bspec, bspec),
        out_specs=(bspec, cache_p),
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
