"""LM pretraining: the port's own train step (``steps.make_step`` at a
``ShapeSpec`` of kind train, ``init_train_state``) on random weights from
the seed, fed rows of token ids drawn uniformly from the configuration's
vocabulary (its held slice), packed full: no padding, no document masks.

Parameters (the cell's file): ``seq_len``, ``batch`` (sequences a step),
``microbatches``, ``warm_steps`` (in set-up), ``trace_steps`` (the traced
slice, after the window), ``check_edge`` (positions compared at each end
of a row), ``limits`` (of the compared numbers). The configuration's
``optimizer`` gives the step's schedule and AdamW's settings.

Judged once the window and the traced slice have closed, untimed, on one
held batch of ``batch`` rows (its own stream of the seed), against the
plain float32 reference (``tmbench/reference/deepseek_v2.py``):

* one more step of the timed step function on the held batch, from the
  state as the window left it: ``update_err``, the largest ‖Δθ − Δθ_ref‖ /
  ‖Δθ_ref‖ over layer 1's ``wq``, ``wkv_a``, ``wkv_b`` and ``wo``, the last
  layer's router and ``lm_head``, where ``Δθ_ref`` is the reference's AdamW
  step from the same masters and moments on the mean of its float32
  gradients of the microbatches, clipped by their global norm (the step
  compresses nothing); ``step_grad_err``, the same leaves' new first
  moment against the reference's, over the share the step added to it
  (``(1 - b1)`` times the clipped gradient). A step that leaves the state
  as it was reads 1 and about 1; one that takes half of its batch reads
  high on the second;
* on the first microbatch, from the masters as they were before that step
  (kept on the host across it), the program's own loss (its bf16 forward
  and backward, ``steps.train_loss``): ``logits_err``, max|Δ| / max|ref| of
  the logits at the first and the last ``check_edge`` positions of each
  row; ``grad_err``, the largest ‖Δ‖ / ‖ref‖ of the gradients of layer 1's
  ``wq``, ``wkv_a``, ``wkv_b`` and ``wo`` and of the last layer's router;
* ``nonfinite_steps``: window steps whose loss was not finite.

Read and logged, not compared (``data``): ``loss_err`` (|Δ| of the loss),
``expert_grad_err`` (the last layer's first held expert's ``w_down``) and
both sides' global gradient norms. The bf16 program and the control one
precision below read alike on the first two, since bf16 routing flips the
near-tied k-th expert of some tokens, so no limit could lie between them.
The float32 CPU tests hold both exactly.
"""
from __future__ import annotations

import time

import torch

from tmbench import gen as G
from tmbench import harness, lm_counts
from tmbench.lm_spans import LMSlice
from tmbench.reference import deepseek_v2 as ref
from tmbench.trace import per_second

# no planted fault that ``tmbench.control`` names fits this kind; the LM
# family's own (``families/lm.py`` ``FAULTS``) run with tmbench.lm_control
FAULTS = ()
# the CPU tests' parameters (tmbench/testing.py), with the tests' cut's
# own limits: at 48 positions and 8 experts, bf16 routing flips move even
# the last router's gradient (program 0.017-0.112 over 6 seeds, the control
# 0.090-0.484), so the logits decide there (program 0.0080-0.0104, the
# control 0.038-0.070, the faults 0.17-0.53); the step's numbers over 11
# seeds: program update_err 0.011-0.139 and step_grad_err 0.017-0.214,
# half_batch 0.40-0.55 and 0.80-0.88, step_skipped 1 and 1
TINY_PARAMS = {"seq_len": 48, "batch": 4, "microbatches": 2, "warm_steps": 1,
               "trace_steps": 1, "check_edge": 8,
               "limits": {"logits_err": 0.025, "grad_err": 0.3,
                          "update_err": 0.3, "step_grad_err": 0.45}}


def _block(cfg, i: int) -> str:
    """The parameter prefix of layer ``i`` (from 0) of the port's ``LM``."""
    nd = cfg.n_dense_layers
    return f"head.{i}" if i < nd else f"layers.{i - nd}.b0_attn_moe"


def compared_params(cfg) -> list[tuple[str, int | None]]:
    """``(parameter name, index or None)`` of the gradients read: those
    compared, then the expert's ``w_down``."""
    first, last = _block(cfg, 1), _block(cfg, cfg.n_layers - 1)
    return ([(f"{first}.attn.{w}.weight", None) for w in ("wq", "wkv_a", "wkv_b", "wo")]
            + [(f"{last}.moe.router", None), (f"{last}.moe.w_down", 0)])


def update_params(cfg) -> list[str]:
    """The parameters whose step is compared."""
    return [n for n, i in compared_params(cfg) if i is None] + ["lm_head.weight"]


def _edges(logits: torch.Tensor, edge: int) -> torch.Tensor:
    return torch.cat([logits[:, :edge], logits[:, -edge:]], 1).detach().float()


def _grad(named: dict, name: str, index) -> torch.Tensor:
    g = named[name].grad
    return (g if index is None else g[index]).detach().clone()


def _microbatch(ctx, batch: dict, i: int) -> dict:
    """Microbatch ``i`` of ``batch``: its rows in order, as the step splits it."""
    rows = ctx.cell.params["batch"] // ctx.cell.params["microbatches"]
    return {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}


def snapshot(state: dict, leaves) -> dict:
    """The step count and ``leaves``' masters and Adam moments."""
    named = dict(state["params"].named_parameters())
    opt = state["opt"]
    return {"step": int(opt.step),
            "theta": {n: named[n].detach().clone() for n in leaves},
            "m": {n: opt.mu[n].clone() for n in leaves},
            "v": {n: opt.nu[n].clone() for n in leaves}}


def _drop_optimizer(state: dict) -> None:
    """Free the optimizer's state: only the masters are judged on."""
    state.pop("opt", None)
    state.pop("ef", None)


def program_side(ctx, state: dict, step, batch: dict, names, pre: dict) -> dict:
    """The program's numbers: the change ``step`` makes to ``pre``'s leaves
    on ``batch`` and their new first moment; then, with the optimizer's
    state freed and the masters put back as they were before the step,
    its loss, edge logits and compared gradients on the first microbatch."""
    from repro_torch import steps

    params = state["params"]
    named = dict(params.named_parameters())
    before = {n: p.detach().to("cpu", copy=True) for n, p in named.items()}
    new, metrics = step(dict(state), batch)
    out = {"delta": {n: named[n].detach() - t for n, t in pre["theta"].items()},
           "m": {n: new["opt"].mu[n].clone() for n in pre["theta"]},
           "grad_norm": float(metrics["grad_norm"])}
    del new
    _drop_optimizer(state)
    ctx.free()
    with torch.no_grad():
        for n, p in named.items():
            p.copy_(before.pop(n))
    mb = _microbatch(ctx, batch, 0)
    for p in named.values():
        p.grad = None
    with torch.enable_grad():
        loss, _, logits = steps.train_loss(ctx.cfg, params, mb,
                                           aux_coef=ctx.cell.config["aux_loss_alpha"])
        loss.backward()
    out.update(loss=float(loss.detach()),
               edges=_edges(logits, ctx.cell.params["check_edge"]),
               grads={n: _grad(named, n, i) for n, i in names})
    for p in named.values():
        p.grad = None
    return out


def reference_side(ctx, params, batch: dict, names, pre: dict,
                   low: bool = False) -> dict:
    """The reference's numbers from the masters (``low``: the control's
    precision): its loss, edge logits and compared gradients on the first
    microbatch, and the AdamW step of ``pre``'s leaves on the mean of every
    microbatch's gradients, clipped by their global norm."""
    family = harness.family_module(harness.family_of(ctx.cell.config))
    weights = family.reference_weights(params)
    conf, cfg = ctx.cell.config, ctx.cfg
    named = dict(params.named_parameters())
    m = ctx.cell.params["microbatches"]
    for p in named.values():
        p.grad = None
    with torch.enable_grad():
        for i in range(m):
            mb = _microbatch(ctx, batch, i)
            loss, logits = ref.loss(weights, mb["tokens"], mb["labels"], conf,
                                    (0, cfg.n_held), low=low)
            loss.backward()
            if i == 0:
                out = {"loss": float(loss.detach()),
                       "edges": _edges(logits, ctx.cell.params["check_edge"]),
                       "grads": {n: _grad(named, n, j) for n, j in names}}
            del loss, logits
    grads = [p.grad for p in named.values() if p.grad is not None]
    gnorm = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads]))) / m
    out.update(grad_norm=gnorm, delta={}, m={})
    for n, theta in pre["theta"].items():
        out["delta"][n], out["m"][n] = ref.adamw(
            theta, named[n].grad / m, pre["m"][n], pre["v"][n], pre["step"],
            gnorm, conf["optimizer"])
    for p in named.values():
        p.grad = None
    return out


def control_side(ctx, state: dict, step, batch: dict, names, pre: dict) -> dict:
    """The control: the reference one precision below the program's, in
    the program's place (the step is not taken)."""
    _drop_optimizer(state)
    ctx.free()
    return reference_side(ctx, state["params"], batch, names, pre, low=True)


def _rel(a: dict, b: dict, base: dict | None = None) -> dict:
    """‖a − b‖ / ‖b − base‖ of each tensor (``base`` zero by default)."""
    return {n: float(torch.linalg.vector_norm(a[n] - t)
                     / torch.linalg.vector_norm(t if base is None else t - base[n]))
            for n, t in b.items()}


def errors(prog: dict, want: dict, pre: dict, b1: float) -> dict:
    """The numbers of the program's side against the reference's."""
    scale = float(want["edges"].abs().max())
    grads = _rel(prog["grads"], want["grads"])
    expert = grads.pop(next(n for n in grads if n.endswith(".w_down")))
    older = {n: b1 * t for n, t in pre["m"].items()}
    return {"logits_err": float((prog["edges"] - want["edges"]).abs().max()) / scale,
            "grad_err": max(grads.values()),
            "update_err": max(_rel(prog["delta"], want["delta"]).values()),
            "step_grad_err": max(_rel(prog["m"], want["m"], older).values()),
            "loss_err": abs(prog["loss"] - want["loss"]),
            "expert_grad_err": expert}


def run(ctx) -> dict:
    """Set up the model and its train state, warm up, train for the window
    and the traced slice, then judge one more step on a held batch."""
    from repro_torch import spans, steps
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import transformer

    cfg, p, dev = ctx.cfg, ctx.cell.params, ctx.device
    s, b = p["seq_len"], p["batch"]
    opt = ctx.cell.config["optimizer"]
    rows_gen = G.generator(ctx.seed, "rows", dev)

    def draw(n: int, gen: torch.Generator) -> dict:
        rows = torch.randint(0, cfg.vocab, (n, s + 1), generator=gen, device=dev)
        return {"tokens": rows[:, :-1].to(torch.int32),
                "labels": rows[:, 1:].to(torch.int32)}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    ctx.reset_peak()
    params = transformer.init_params(G.generator(ctx.seed, "weights", dev), cfg)
    state = steps.init_train_state(params)
    step = steps.make_step(cfg, ShapeSpec("lm_train", "train", s, b),
                           microbatches=p["microbatches"],
                           aux_coef=ctx.cell.config["aux_loss_alpha"],
                           peak_lr=opt["peak_lr"], warmup_steps=opt["warmup_steps"],
                           total_steps=opt["total_steps"]).fn
    for _ in range(p["warm_steps"]):
        state, _ = step(state, draw(b, rows_gen))
    sync()
    losses, ends = [], []
    with spans.counting() as counts:
        t0 = ctx.open_window()
        while True:
            state, metrics = step(state, draw(b, rows_gen))
            losses.append(metrics["loss"])
            sync()
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= ctx.seconds:
                break
    window_s = time.perf_counter() - t0
    n_steps = len(losses)
    counted = {k: int(v) for k, v in counts.items()}
    nonfinite = int((~torch.isfinite(torch.stack(losses))).sum())
    trace, traced = None, {}
    if ctx.trace:
        LMSlice.warm(dev)
        with spans.counting() as tc, LMSlice(dev) as sl:
            for _ in range(p["trace_steps"]):
                state, _ = step(state, draw(b, rows_gen))
        trace = sl.summary()
        traced = {k: int(v) for k, v in tc.items()}
    peak = ctx.peak()

    t_ref = time.perf_counter()
    names = compared_params(cfg)
    held = draw(b, G.generator(ctx.seed, "held", dev))
    pre = snapshot(state, update_params(cfg))
    prog = program_side(ctx, state, step, held, names, pre)
    del state, step
    ctx.free()
    want = reference_side(ctx, params, held, names, pre)
    err = errors(prog, want, pre, opt["b1"])
    lim = p["limits"]
    tokens = n_steps * b * s
    window_flops = lm_counts.step_flops(cfg, tokens, counted.get("lm.moe.kept", 0), s)
    t_tokens = p["trace_steps"] * b * s
    ctx.log(f"window: {n_steps} steps of {b} x {s} tokens in {window_s:.3f} s; "
            f"counters {counted}; losses {[round(float(x), 4) for x in losses[:3]]} "
            f"... {float(losses[-1]):.4f}; compared {err} (gradients "
            f"{_rel(prog['grads'], want['grads'])}; steps "
            f"{_rel(prog['delta'], want['delta'])}; grad norms "
            f"{prog['grad_norm']:.6g} / {want['grad_norm']:.6g}; step count "
            f"{pre['step']}) in {time.perf_counter() - t_ref:.3f} s; steps "
            f"ending in each second {per_second(ends)}")
    compared = {k: (err[k], lim[k]) for k in
                ("logits_err", "grad_err", "update_err", "step_grad_err")}
    return {"attempted": n_steps * b, "failed": nonfinite * b,
            "compared": {**compared, "nonfinite_steps": (nonfinite, 0)},
            "memory_peak_bytes": peak,
            "data": {"samples": n_steps * b, "window_s": window_s,
                     "tokens": tokens, "counters": counted,
                     "loss_err": err["loss_err"],
                     "expert_grad_err": err["expert_grad_err"],
                     "grad_norms": [prog["grad_norm"], want["grad_norm"]],
                     "window_flops": window_flops,
                     "traced_counters": traced,
                     "traced_mla_flops": lm_counts.mla_flops(cfg, t_tokens, s)},
            "trace": trace}
