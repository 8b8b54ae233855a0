"""Gradient compression with error feedback (the port's
``repro.optim.compression``).

``bf16`` rounds each gradient to bf16; ``int8`` quantises it with one
scale per tensor (``max|g| / 127``). Either way the rounding residual is
kept in float32 and added to the next step's gradient, so the training
trajectory converges to the uncompressed one. ``none`` passes gradients
through. ``init_error_feedback`` allocates the float32 residuals in every
mode, as the reference does (the state has the same parts whatever the
mode).

On a mesh (``compress_grads_sharded``) the residuals are sharded like the
parameters and int8's per-tensor scale is the ``pmax`` of its shards'
maxima, the scale of the whole tensor.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.optim.adamw import _named
from repro_torch.sharding import PerRank, pmax


class ErrorFeedback(NamedTuple):
    """``residual``: ``{name: float32 tensor}``, the parameters' shapes."""

    residual: dict


def init_error_feedback(params) -> ErrorFeedback:
    """Zero float32 residuals for a module or a ``{name: tensor}`` dict."""
    return ErrorFeedback({n: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device)
                          for n, p in _named(params).items()})


def _compress_bf16(g):
    c = g.to(torch.bfloat16)
    return c, g - c.float()


def _compress_int8(g, amax=None):
    amax = g.abs().max() if amax is None else amax
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq, g - deq


@torch.no_grad()
def compress_grads(grads: dict, ef: ErrorFeedback, *, mode: str = "bf16"):
    """(compressed grads, new error feedback); mode "none" | "bf16" |
    "int8". bf16 grads come back as bf16 tensors, int8 ones dequantised
    to float32."""
    if mode == "none":
        return grads, ef
    fn = {"bf16": _compress_bf16, "int8": _compress_int8}[mode]
    comp, res = {}, {}
    for n, g in grads.items():
        comp[n], res[n] = fn(g.float() + ef.residual[n])
    return comp, ErrorFeedback(res)


@torch.no_grad()
def compress_grads_sharded(grads: dict, ef: ErrorFeedback, specs: dict, mesh,
                           *, mode: str = "bf16"):
    """``compress_grads`` of ``{name: PerRank}`` laid out by ``specs`` (the
    residuals too); int8 scales each tensor by the max over all its
    shards."""
    if mode == "none":
        return grads, ef
    if mode not in ("bf16", "int8"):
        raise KeyError(mode)
    comp, res = {}, {}
    for n, g in grads.items():
        x = [t.float() + r for t, r in zip(g, ef.residual[n])]
        if mode == "int8":
            axes = tuple(a for a in mesh.axis_names if a in specs[n].axes())
            amax = pmax([t.abs().max() for t in x], mesh, axes)
            out = [_compress_int8(t, a) for t, a in zip(x, amax)]
        else:
            out = [_compress_bf16(t) for t in x]
        comp[n] = PerRank(c for c, _ in out)
        res[n] = PerRank(r for _, r in out)
    return comp, ErrorFeedback(res)
