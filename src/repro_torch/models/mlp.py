"""Dense MLPs: gated SwiGLU (llama family) and the non-gated form (GELU for
whisper, squared ReLU for minitron). The port's ``repro.models.mlp``.

On a mesh: tensor-parallel over ``model`` with the weights gathered over
``data`` (``mlp_sharded``), or, in a weight-stationary decode step, each
rank's own shards against the residual's ``data`` slice
(``mlp_stationary``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import (
    activation,
    empty_linear,
    init_linear_,
    linear_f32,
)
from repro_torch.sharding import DATA, MODEL, psum, psum_scatter


class MLP(nn.Module):
    """``w_up``, ``w_down`` and, when gated, ``w_gate`` (no biases)."""

    def __init__(self, d_model: int, d_ff: int, *, gated: bool = True,
                 device=None):
        super().__init__()
        self.w_up = empty_linear(d_model, d_ff, device=device)
        self.w_down = empty_linear(d_ff, d_model, device=device)
        self.w_gate = empty_linear(d_model, d_ff, device=device) if gated else None


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, *,
             gated: bool = True) -> MLP:
    """An ``MLP`` on the generator's device with ``dense_init`` weights."""
    p = MLP(d_model, d_ff, gated=gated, device=gen.device)
    for lin in (p.w_up, p.w_down, p.w_gate):
        if lin is not None:
            init_linear_(gen, lin)
    return p


def _hidden(p: MLP, x: torch.Tensor, act: str) -> torch.Tensor:
    """``act(gate) * up`` (gated) or ``act(up)``, in x's dtype."""
    fn = activation(act)
    up = F.linear(x, p.w_up.weight.to(x.dtype))
    if p.w_gate is not None:
        return fn(F.linear(x, p.w_gate.weight.to(x.dtype))) * up
    return fn(up)


def mlp(p: MLP, x: torch.Tensor, *, act: str = "silu") -> torch.Tensor:
    """``act(gate) * up`` (gated) or ``act(up)``, then down, in x's dtype."""
    return F.linear(_hidden(p, x, act), p.w_down.weight.to(x.dtype))


def mlp_sharded(ps, hs, *, act: str = "silu", mesh, axis, scatter_dim=None):
    """Tensor-parallel ``mlp``: rank ``r`` holds a ``d_ff`` slice
    (``w_gate`` / ``w_up`` column-parallel, ``w_down`` row-parallel, each
    already gathered over ``data``), so ``mlp`` on it gives a partial sum
    (kept in float32), reduced over ``axis``: a ``psum``, or with
    ``scatter_dim`` a reduce-scatter along that dim (the sequence-split
    residual). The sums are float32."""
    ys = [linear_f32(_hidden(p, h, act), p.w_down.weight)
          for p, h in zip(ps, hs)]
    if scatter_dim is None:
        return psum(ys, mesh, axis)
    return psum_scatter(ys, mesh, axis, scatter_dim)


def mlp_stationary(ps, hs, *, act: str = "silu", mesh):
    """``mlp`` of one decode token with the weights stationary: ``hs[r]``
    (rows, 1, d/|data|) the rank's ``data`` slice of the normed residual,
    ``ps[r]`` rank r's shards ((f/|model|, d/|data|) of ``w_gate`` /
    ``w_up``, (d/|data|, f/|model|)
    of ``w_down``). The gate and up partials are summed over ``data`` in
    one ``psum`` (float32, every row of the rank's ``f`` slice), the
    hidden meets the ``w_down`` shard, and a ``psum`` over ``model`` gives
    each rank its (rows, 1, d/|data|) slice of the output, float32."""
    fn = activation(act)
    ups = psum([torch.cat([linear_f32(h, lin.weight) for lin in (p.w_up, p.w_gate)
                           if lin is not None], -1) for p, h in zip(ps, hs)],
               mesh, DATA)
    ys = []
    for p, h, u in zip(ps, hs, ups):
        u = u.to(h.dtype)
        if p.w_gate is not None:
            up, gate = u.chunk(2, -1)
            hidden = fn(gate) * up
        else:
            hidden = fn(u)
        ys.append(linear_f32(hidden, p.w_down.weight))
    return psum(ys, mesh, MODEL)
