"""Learning rate schedules: pure functions of the step (the port's
``repro.optim.schedule``).

Computed in float32 as the reference computes them (its Python constants
are weakly typed, so each is rounded to float32 before it meets the step),
because the learning rate feeds every parameter of every step.
"""
from __future__ import annotations

import math

import torch


def _f32(value, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def cosine_with_warmup(step, *, peak_lr, warmup_steps, total_steps,
                       min_ratio=0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a cosine to
    ``min_ratio · peak_lr`` at ``total_steps``; a 0-d float32 tensor on
    the step's device."""
    step = torch.as_tensor(step).to(torch.float32)
    one = _f32(1.0, step)
    warm = _f32(peak_lr, step) * step / torch.maximum(one, _f32(warmup_steps, step))
    t = torch.clamp((step - _f32(warmup_steps, step))
                    / torch.maximum(one, _f32(total_steps - warmup_steps, step)),
                    0.0, 1.0)
    cos = _f32(peak_lr, step) * (
        _f32(min_ratio, step) + _f32((1 - min_ratio) * 0.5, step)
        * (1 + torch.cos(_f32(math.pi, step) * t)))
    return torch.where(step < warmup_steps, warm, cos)


def constant(step, *, peak_lr, **_) -> torch.Tensor:
    """``peak_lr`` as a 0-d float32 tensor on the step's device."""
    return _f32(peak_lr, torch.as_tensor(step))
