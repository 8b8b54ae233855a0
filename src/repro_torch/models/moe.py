"""Mixture-of-Experts: grouped top-k routing, shared experts, two dispatch
engines (the port's ``repro.models.moe`` on one device).

Grouping (GShard/Switch semantics): tokens are reshaped (B, S, d) →
(G, T_g, d) with G = batch size, and all routing state (ranks, capacity,
dispatch tables) is per group.

Dispatch engines (identical outputs, drops included):
  * ``einsum`` — GShard one-hot dispatch/combine einsums (O(T_g·E·C) extra
    work);
  * ``sort``   — capacity-slot ``index_select`` / ``index_add`` (O(E·C·d)
    data movement).

Capacity: C = max(1, int(cf·T_g·k/E)) per group; ``dropless`` sets C = T_g,
which is what inference uses. Expert weights stay stacked ``(E, d, f)`` /
``(E, f, d)`` parameters and the products are ``torch.einsum`` (batched
GEMMs over the expert axis).

Held experts: a layer may hold a contiguous range of the router's E experts
(``MoE(n_held=…)``, the range starting at ``moe_block(base=…)``), as one
rank of an expert-parallel deployment does. The router keeps all E outputs
and its top-k over them; capacity still counts all E; the layer computes
its held experts' share of the routed output and leaves out assignments to
experts held elsewhere (only the ``sort`` engine, whose full layer is the
range of all E). Shared experts are
computed once, behind a sigmoid ``shared_gate`` or, without one, added
ungated. ``spans.count`` tallies the assignments kept, dropped and absent.

On a mesh (an active ``Policy``, per-rank lists), ``moe_block`` runs
``_moe_shard_map``, the reference's explicit-collective engine: groups on
the batch axes, one tiled all-gather over ``data`` of the router and each
expert stack, the local engine unchanged on the rank's ``f`` slice, one
``psum`` over ``model`` of the combined output and a ``pmean`` of the
load-balance statistics over the batch axes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import (
    activation,
    init_linear_,
    truncated_normal_,
)
from repro_torch import spans
from repro_torch.launch.mesh import axis_size
from repro_torch.models.mlp import MLP, mlp, mlp_sharded
from repro_torch.sharding import DATA, all_gather, module_view, pmean, psum
from repro_torch.spans import span


class MoE(nn.Module):
    """``router`` (d, E) and the stacked experts ``w_gate`` / ``w_up``
    (E_held, d, f) and ``w_down`` (E_held, f, d), in the reference's layout
    (E_held = ``n_held``, default E); with shared experts also ``shared`` (a
    gated ``MLP``) and, when ``shared_gate``, the gate's (d, 1) weight
    ``shared_gate``."""

    def __init__(self, d_model: int, d_ff_expert: int, n_experts: int, *,
                 n_shared: int = 0, d_ff_shared=None, device=None,
                 n_held=None, shared_gate: bool = True):
        super().__init__()

        def empty(*shape):
            return nn.Parameter(torch.empty(shape, device=device))

        held = n_experts if n_held is None else n_held
        self.router = empty(d_model, n_experts)
        self.w_gate = empty(held, d_model, d_ff_expert)
        self.w_up = empty(held, d_model, d_ff_expert)
        self.w_down = empty(held, d_ff_expert, d_model)
        self.shared = self.shared_gate = None
        if n_shared:
            d_sh = d_ff_shared or n_shared * d_ff_expert
            self.shared = MLP(d_model, d_sh, gated=True, device=device)
            if shared_gate:
                self.shared_gate = empty(d_model, 1)


@torch.no_grad()
def init_moe(gen: torch.Generator, d_model: int, d_ff_expert: int,
             n_experts: int, *, n_shared: int = 0, d_ff_shared=None,
             n_held=None, shared_gate: bool = True) -> MoE:
    """A ``MoE`` on the generator's device with the reference's
    distributions: fan-in scaled truncated normals, where the stacked
    experts' fan-in is ``E·d`` (gate, up) and ``E·f`` (down), as the
    reference draws them flat and reshapes (E the router's width, also
    when the layer holds fewer)."""
    p = MoE(d_model, d_ff_expert, n_experts, n_shared=n_shared,
            d_ff_shared=d_ff_shared, device=gen.device, n_held=n_held,
            shared_gate=shared_gate)
    truncated_normal_(p.router, gen, d_model ** -0.5)
    truncated_normal_(p.w_gate, gen, (n_experts * d_model) ** -0.5)
    truncated_normal_(p.w_up, gen, (n_experts * d_model) ** -0.5)
    truncated_normal_(p.w_down, gen, (n_experts * d_ff_expert) ** -0.5)
    if n_shared:
        for lin in (p.shared.w_up, p.shared.w_down, p.shared.w_gate):
            init_linear_(gen, lin)
        if shared_gate:
            truncated_normal_(p.shared_gate, gen, d_model ** -0.5)
    return p


def _route(p: MoE, x, top_k, *, normalize=True):
    """x: (G, T, d) → (gates (G,T,k), experts (G,T,k), (me, ce)).

    The router product is float32 whatever the weights' dtype (the
    reference's ``x.astype(float32) @ router`` promotes a bf16 router)."""
    logits = x.float() @ p.router.float()
    probs = torch.softmax(logits, dim=-1)                 # (G, T, E)
    gates, experts = torch.topk(probs, top_k, dim=-1)
    if normalize:
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    e = probs.shape[-1]
    me = probs.mean((0, 1))
    ce = F.one_hot(experts[..., 0], e).float().mean((0, 1))
    # Switch aux loss factors, reduced to a scalar by the caller
    return gates, experts, (me, ce)


def _slots(experts, top_k, e, capacity):
    """Per-group rank of each (token, k) within its expert.

    experts: (G, T, k) → (slot (G,T,k) int64, keep (G,T,k)). A stable sort
    by expert id ranks tokens in token order, so the same tokens are
    dropped as in the reference."""
    g, t, k = experts.shape
    tk = t * k
    exp_f = experts.reshape(g, tk)
    order = torch.argsort(exp_f, dim=1, stable=True)      # (G, TK)
    sorted_exp = torch.gather(exp_f, 1, order)
    counts = torch.zeros((g, e), dtype=torch.int64, device=experts.device)
    counts.scatter_add_(1, exp_f, torch.ones_like(exp_f))
    starts = counts.cumsum(1) - counts                    # exclusive
    rank_sorted = (torch.arange(tk, device=experts.device)[None]
                   - torch.gather(starts, 1, sorted_exp))
    slot = torch.zeros_like(exp_f).scatter_(1, order, rank_sorted)
    slot = slot.reshape(g, t, k)
    return slot, slot < capacity


def _expert_ffn(p: MoE, h, act_fn):
    """h: (G, E, C, d) → (G, E, C, d) through each expert's SwiGLU."""
    gate = torch.einsum("gecd,edf->gecf", h, p.w_gate.to(h.dtype))
    up = torch.einsum("gecd,edf->gecf", h, p.w_up.to(h.dtype))
    return torch.einsum("gecf,efd->gecd", act_fn(gate) * up,
                        p.w_down.to(h.dtype))


def moe_einsum(p: MoE, x, *, top_k, capacity, act="silu", normalize=True):
    """GShard one-hot dispatch. x: (G, T, d) → (out (G,T,d), (me, ce))."""
    e = p.router.shape[-1]
    gates, experts, aux = _route(p, x, top_k, normalize=normalize)
    slot, keep = _slots(experts, top_k, e, capacity)
    oh_e = F.one_hot(experts, e).to(x.dtype)              # (G,T,k,E)
    # a dropped (token, k) takes class ``capacity``, sliced off: a zero row
    oh_c = F.one_hot(torch.where(keep, slot, capacity),
                     capacity + 1)[..., :capacity].to(x.dtype)  # (G,T,k,C)
    disp = torch.einsum("gtke,gtkc->gtec", oh_e, oh_c)    # (G,T,E,C)
    h = torch.einsum("gtec,gtd->gecd", disp, x)
    out_e = _expert_ffn(p, h, activation(act))
    comb = torch.einsum("gtke,gtkc,gtk->gtec", oh_e, oh_c, gates.to(x.dtype))
    return torch.einsum("gtec,gecd->gtd", comb, out_e), aux


def _count(keep, held) -> None:
    """Tally the (token, k) assignments kept, dropped and absent."""
    if not spans.counters_open():
        return
    spans.count("lm.moe.kept", (keep & held).sum())
    spans.count("lm.moe.dropped", (held & ~keep).sum())
    spans.count("lm.moe.absent", (~held).sum())


def moe_sort(p: MoE, x, *, top_k, capacity, act="silu", normalize=True,
             base=0):
    """Capacity-slot dispatch (no O(T·E·C) einsum) over the held experts
    ``[base, base + E_held)`` (all E by default). x: (G, T, d).

    Slot-centred: a (G, E_held·C) table gives each slot its token and its
    gate, the experts' inputs are one ``index_select`` of the tokens and
    the combine one ``index_add`` of the gated outputs, so neither pass
    nor its backward visits an assignment that is not computed here. An
    empty slot reads the token its index names modulo T and adds zero to
    it, so empty slots spread over the rows instead of piling onto one."""
    g, t, d = x.shape
    e = p.router.shape[-1]
    n = p.w_gate.shape[0]
    with span("lm.moe.route"):
        gates, experts, aux = _route(p, x, top_k, normalize=normalize)
    slot, keep = _slots(experts, top_k, e, capacity)
    local = experts - base
    held = (local >= 0) & (local < n)
    mine = keep & held
    _count(keep, held)
    dev = x.device
    nc = n * capacity
    # each computed assignment's slot in the flat (E_held·C) table; every
    # other one writes column ``nc``, which is sliced off
    pos = torch.where(mine, local * capacity + slot, nc).reshape(g, t * top_k)
    tok_f = torch.arange(t, device=dev).repeat_interleave(top_k)[None]
    spread = torch.arange(nc + 1, device=dev) % t
    table = spread.expand(g, -1).clone()
    table.scatter_(1, pos, tok_f.expand(g, -1))
    rows = (table[:, :nc]
            + t * torch.arange(g, device=dev)[:, None]).reshape(g * nc)
    gate_slot = gates.new_zeros(g, nc + 1).scatter(
        1, pos, gates.reshape(g, t * top_k))[:, :nc]       # 0: an empty slot
    h = x.reshape(g * t, d).index_select(0, rows).reshape(g, n, capacity, d)
    out_e = _expert_ffn(p, h, activation(act)).reshape(g * nc, d)
    out = x.new_zeros(g * t, d, dtype=torch.float32).index_add(
        0, rows, out_e.float() * gate_slot.reshape(g * nc, 1))
    return out.to(x.dtype).reshape(g, t, d), aux


def _moe_shard_map(ps, xgs, *, top_k, capacity, act, policy, dispatch,
                   normalize):
    """Explicit-collective MoE over ``policy.mesh`` (per-rank lists).

    ``ps[r]`` holds rank r's shards of the router (d/|data|, E) and the
    experts (E, d/|data|, f/|model|) / (E, f/|model|, d/|data|); ``xgs[r]``
    its groups (G/|batch|, T, d), every token. The four weights are
    all-gathered over ``data`` (their backward is the reduce-scatter of
    the weight gradients); routing, dispatch, the experts on the local
    ``f`` slice and the combine run locally, the combined output being a
    partial sum over ``f``; ONE ``psum`` over ``model`` reduces it; ``me``
    and ``ce`` are averaged over the batch axes. Returns (outputs, (me, ce))
    as per-rank lists."""
    mesh = policy.mesh
    engine = {"einsum": moe_einsum, "sort": moe_sort}[dispatch]
    gathered = {
        "router": all_gather([p.router for p in ps], mesh, DATA, 0),
        "w_gate": all_gather([p.w_gate for p in ps], mesh, DATA, 1),
        "w_up": all_gather([p.w_up for p in ps], mesh, DATA, 1),
        "w_down": all_gather([p.w_down for p in ps], mesh, DATA, 2),
    }
    outs, mes, ces = [], [], []
    for r, (p, xl) in enumerate(zip(ps, xgs)):
        p_local = module_view(p, {n: t[r] for n, t in gathered.items()})
        out, (me, ce) = engine(p_local, xl, top_k=top_k, capacity=capacity,
                               act=act, normalize=normalize)
        outs.append(out)
        mes.append(me)
        ces.append(ce)
    outs = psum(outs, mesh, policy.model_axis)   # token-sized TP reduce
    if policy.batch_axes:                        # exact global aux stats
        mes = pmean(mes, mesh, policy.batch_axes)
        ces = pmean(ces, mesh, policy.batch_axes)
    return outs, (mes, ces)


def _moe_block_sharded(ps, xs, *, top_k, capacity_factor, act, policy,
                       dispatch, normalize, num_groups, dropless):
    """``moe_block`` on a mesh: ``xs[r]`` (B/|batch|, S, d) is rank r's
    batch rows. The capacity comes from the groups' token count (the
    batch's groups split over the batch axes; each holds T_g tokens on
    one rank). A shared expert is the tensor-parallel ``mlp`` (its
    weights in ``ps[r]`` already gathered over ``data``)."""
    mesh = policy.mesh
    b, s, d = xs[0].shape
    nb = axis_size(mesh, policy.batch_axes)
    g = num_groups or b * nb
    tg = (b * nb * s) // g
    e = ps[0].router.shape[-1]
    capacity = tg if dropless else max(1, int(capacity_factor * tg * top_k / e))
    outs, (mes, ces) = _moe_shard_map(
        ps, [x.reshape(g // nb, tg, d) for x in xs], top_k=top_k,
        capacity=capacity, act=act, policy=policy, dispatch=dispatch,
        normalize=normalize)
    aux = [e * torch.sum(me * ce) for me, ce in zip(mes, ces)]
    outs = [o.reshape(b, s, d) for o in outs]
    if ps[0].shared is not None:
        shs = mlp_sharded([p.shared for p in ps], xs, act=act, mesh=mesh,
                          axis=policy.model_axis)
        outs = [o + torch.sigmoid(x @ p.shared_gate.to(x.dtype)) * sh.to(x.dtype)
                for o, x, p, sh in zip(outs, xs, ps, shs)]
    return outs, aux


def shared_out(p: MoE, x, *, act="silu"):
    """The shared experts' output, behind ``shared_gate`` when the layer
    has one."""
    sh = mlp(p.shared, x, act=act)
    if p.shared_gate is None:
        return sh
    return torch.sigmoid(x @ p.shared_gate.to(x.dtype)) * sh


def moe_block(p: MoE, x, *, top_k, capacity_factor, act="silu",
              dispatch="sort", normalize=True, num_groups=None,
              dropless=False, policy=None, base=0):
    """x: (B, S, d) → (out, aux). Groups are batch rows (GShard); shared
    experts, if any, are always active.

    ``dropless=True`` sizes capacity to the per-group token count, so no
    token overflows its expert. Inference runs dropless (a prefill that
    drops tokens could never agree with step-by-step decode, where each
    single-token group fits); training keeps the capacity drops.

    A layer holding fewer experts than its router's (``p.w_gate``'s E_held
    < E) computes experts ``[base, base + E_held)``; only the ``sort``
    engine, on one device.

    With an active ``policy`` (a mesh with a model axis), ``p`` and ``x``
    are per-rank lists and the block runs ``_moe_shard_map``; returns
    per-rank (out, aux) lists.
    """
    if policy is not None and policy.active:
        if policy.model_axis is None:
            raise NotImplementedError("a sharded MoE block needs a model axis")
        return _moe_block_sharded(
            p, x, top_k=top_k, capacity_factor=capacity_factor, act=act,
            policy=policy, dispatch=dispatch, normalize=normalize,
            num_groups=num_groups, dropless=dropless)
    b, s, d = x.shape
    g = num_groups or b
    tg = (b * s) // g
    e = p.router.shape[-1]
    capacity = tg if dropless else max(1, int(capacity_factor * tg * top_k / e))
    with span("lm.moe"):
        if p.w_gate.shape[0] != e and dispatch != "sort":
            raise NotImplementedError(
                f"a layer holding {p.w_gate.shape[0]} of {e} experts runs the "
                f"sort engine, not {dispatch!r}")
        kw = {"base": base} if dispatch == "sort" else {}
        fn = {"einsum": moe_einsum, "sort": moe_sort}[dispatch]
        out, (me, ce) = fn(p, x.reshape(g, tg, d), top_k=top_k,
                           capacity=capacity, act=act, normalize=normalize,
                           **kw)
        aux = e * torch.sum(me * ce)              # Switch load-balance loss
        out = out.reshape(b, s, d)
        if p.shared is not None:
            out = out + shared_out(p, x, act=act)
    return out, aux
