"""GPipe-style pipeline parallelism over a mesh axis (the port's
``repro.models.pipeline``).

Stages are laid out along a mesh axis; microbatch activations rotate
stage to stage with ``ppermute`` while every stage computes — the classic
bubble-bounded schedule (bubble fraction = (S-1)/(M+S-1)). Single
controller, as the rest of the port's mesh path: one process walks the
ticks and, within a tick, every rank of the mesh.

``gpipe_apply`` is schedule-exact and tested against the sequential stack;
the LM integration point is ``stage_fn = one group of blocks`` with the
groups' params as the stages.
"""
from __future__ import annotations

import torch

from repro_torch.launch.mesh import axis_index, axis_size
from repro_torch.sharding import PerRank, ppermute, psum


def _to(tree, device):
    """Tensors of a tree of dicts, lists and tuples moved to ``device``
    (other leaves, a module on its rank's device say, as they are)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


def gpipe_apply(stage_fn, stage_params, x_micro, *, mesh, axis: str) -> PerRank:
    """Run ``n_stages = |axis|`` pipeline stages over microbatches.

    stage_fn: (params_of_one_stage, x (mb, …)) → (mb, …); same out shape
    stage_params: indexable by stage (a tensor with a leading stage dim, or
    a list of per-stage params); stage s lives on the ranks at
    coordinate s along ``axis``
    x_micro: (n_micro, mb, …) inputs (replicated along ``axis``)
    Returns the (n_micro, mb, …) outputs of the final stage on every rank
    (a ``PerRank``, replicated).

    Tick t: stage 0 reads microbatch t, the others the activation the
    previous tick's ``ppermute`` brought; a stage is active while
    ``0 <= t - s < n_micro`` (an idle stage emits zeros, as the
    reference's ``where`` does); the last stage emits microbatch
    ``t - S + 1``. The outputs live on the last stage, zeros elsewhere,
    and a final ``psum`` over ``axis`` shares them.
    """
    n_stages = axis_size(mesh, axis)
    n_micro = x_micro.shape[0]
    ticks = n_micro + n_stages - 1
    ring = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    sid = [axis_index(mesh, r, axis) for r in range(mesh.size)]
    params = [_to(stage_params[s], dev) for s, dev in zip(sid, mesh.devices)]
    xs = [x_micro.to(dev) for dev in mesh.devices]
    buf = PerRank(torch.zeros_like(x[0]) for x in xs)
    outs = [[torch.zeros_like(x[0]) for _ in range(n_micro)] for x in xs]
    for t in range(ticks):
        ys = PerRank()
        for r, s in enumerate(sid):
            x_in = xs[r][min(t, n_micro - 1)] if s == 0 else buf[r]
            active = 0 <= t - s < n_micro
            y = stage_fn(params[r], x_in) if active else torch.zeros_like(x_in)
            emit = t - (n_stages - 1)
            if s == n_stages - 1 and emit >= 0:
                outs[r][emit] = y
            ys.append(y)
        buf = ppermute(ys, mesh, axis, ring)     # stage s → s+1
    return psum([torch.stack(o) for o in outs], mesh, axis)
