"""Dense MLPs: gated SwiGLU (llama family) and the non-gated form (GELU for
whisper, squared ReLU for minitron). The port's ``repro.models.mlp``."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import activation, empty_linear, init_linear_


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


def mlp(p: MLP, x: torch.Tensor, *, act: str = "silu") -> torch.Tensor:
    """``act(gate) * up`` (gated) or ``act(up)``, then down, in x's dtype."""
    fn = activation(act)
    up = F.linear(x, p.w_up.weight.to(x.dtype))
    if p.w_gate is not None:
        h = fn(F.linear(x, p.w_gate.weight.to(x.dtype))) * up
    else:
        h = fn(up)
    return F.linear(h, p.w_down.weight.to(x.dtype))
