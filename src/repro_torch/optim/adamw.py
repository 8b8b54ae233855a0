"""AdamW with float32 master weights and global-norm clipping (the port's
``repro.optim.adamw``).

The reference's own update, which is not ``torch.optim.AdamW``'s: weight
decay enters as ``lr·(m̂/(√v̂ + eps) + wd·p)``, the bias corrections
``1 − b**t`` are float32 with ``t`` the float32 step, and the gradients are
clipped to a global norm first. The state mirrors the parameters by name
(``mu`` / ``nu``: ``{name: float32 tensor}``, as ``named_parameters``
gives them). ``update`` writes the new parameters and moments in place,
through ``torch._foreach_*`` over groups of at most ``_GROUP_ELEMENTS``
elements, so a step costs a few launches per group and its temporaries
stay within a group's size.

On a mesh the moments are sharded like the parameters (``{name:
PerRank}``) and each rank updates its shards with ``update``, given the
global norm: ``global_norm_sharded`` counts every element once, a
replicated shard on one rank only.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.sharding import PerRank, canonical_ranks, psum

# elements per foreach group: its float32 temporaries are at most 1 GiB each
_GROUP_ELEMENTS = 1 << 28


class AdamWState(NamedTuple):
    """``step`` (0-d int32), ``mu`` and ``nu`` (``{name: float32}``)."""

    step: torch.Tensor
    mu: dict
    nu: dict


def _named(params) -> dict:
    """``{name: tensor}`` of a module's parameters, or the dict itself."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init(params) -> AdamWState:
    """Zero moments (float32) for a module or a ``{name: tensor}`` dict."""
    named = _named(params)
    dev = next(iter(named.values())).device

    def zeros():
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in named.items()}

    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev), zeros(),
                      zeros())


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (a dict or a list), in
    float32: the 2-norm of the per-tensor 2-norms."""
    leaves = [g.float() for g in (grads.values() if isinstance(grads, dict)
                                  else grads)]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(leaves)))


def global_norm_sharded(grads: dict, specs: dict, mesh) -> PerRank:
    """``global_norm`` of ``{name: PerRank}`` laid out by ``specs``, on
    every rank: each rank's sum of squares over the shards it holds one
    copy of (coordinate 0 along the spec's replica axes), a ``psum`` over
    the whole mesh, the square root."""
    local = []
    for r in range(mesh.size):
        leaves = [g[r].float() for n, g in grads.items()
                  if r in canonical_ranks(specs[n], mesh)]
        dev = mesh.devices[r]
        local.append(torch.stack(torch._foreach_norm(leaves)).square().sum()
                     if leaves else torch.zeros((), device=dev))
    return PerRank(torch.sqrt(s) for s in psum(local, mesh, mesh.axis_names))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: dict, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before scaling)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {n: g.float() * scale for n, g in grads.items()}, norm


def _groups(names, params: dict):
    """Consecutive runs of names with at most ``_GROUP_ELEMENTS`` elements
    (a larger tensor alone)."""
    group, size = [], 0
    for n in names:
        if group and size + params[n].numel() > _GROUP_ELEMENTS:
            yield group
            group, size = [], 0
        group.append(n)
        size += params[n].numel()
    if group:
        yield group


@torch.no_grad()
def update(grads: dict, state: AdamWState, params, *, lr, b1: float = 0.9,
           b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
           max_grad_norm: float | None = 1.0, gnorm=None):
    """One AdamW step. ``grads`` is ``{name: tensor}`` (cast to float32),
    ``params`` a module or ``{name: float32 tensor}`` updated in place, as
    are ``state``'s moments. ``gnorm``, when given, is the global norm to
    clip by (a rank's shards on a mesh); else ``global_norm(grads)``.
    Returns (new state, metrics ``grad_norm`` and ``lr``)."""
    named = _named(params)
    gnorm = global_norm(grads) if gnorm is None else gnorm
    scale = (_clip_scale(gnorm, max_grad_norm) if max_grad_norm is not None
             else None)
    step = state.step + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=t.device)
    for names in _groups(list(state.mu), named):
        p = [named[n] for n in names]
        m = [state.mu[n] for n in names]
        v = [state.nu[n] for n in names]
        g = [grads[n].float() for n in names]
        if scale is not None:
            g = torch._foreach_mul(g, scale)
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
        torch._foreach_mul_(v, b2)
        gg = torch._foreach_mul(g, g)
        del g
        torch._foreach_mul_(gg, 1 - b2)
        torch._foreach_add_(v, gg)
        del gg
        mhat = torch._foreach_div(m, bc1)
        denom = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        torch._foreach_div_(mhat, denom)                # m̂ / (√v̂ + eps)
        del denom
        torch._foreach_add_(mhat, torch._foreach_mul(p, weight_decay))
        torch._foreach_mul_(mhat, lr)
        torch._foreach_sub_(p, mhat)
    return AdamWState(step, state.mu, state.nu), {"grad_norm": gnorm, "lr": lr}
