"""Shared neural layers: norms, rope, embeddings, initializers.

The port's counterpart of ``repro.models.common``. Parameters live in
``nn.Module``s (``RMSNorm``, ``LayerNorm``, ``Embed``); the arithmetic is in
plain functions on tensors that follow their input's dtype, as the
reference's do. Random init draws from the caller's ``torch.Generator`` on
the generator's device.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.launch.mesh import axis_index, axis_size
from repro_torch.sharding import psum


def truncated_normal_(t: torch.Tensor, gen: torch.Generator,
                      std: float) -> torch.Tensor:
    """Fill ``t`` in place with ``std`` times a standard normal truncated to
    [-2, 2], drawn from ``gen`` (on ``t``'s device)."""
    return nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen).mul_(std)


def truncated_normal(gen: torch.Generator, shape, std: float,
                     dtype=torch.float32) -> torch.Tensor:
    """A new ``shape`` tensor on ``gen.device`` (see ``truncated_normal_``)."""
    return truncated_normal_(torch.empty(shape, dtype=dtype, device=gen.device),
                             gen, std)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32) -> torch.Tensor:
    """Fan-in scaled init, shape ``(d_in, d_out)`` as the reference's."""
    return truncated_normal(gen, (d_in, d_out), d_in ** -0.5, dtype)


def empty_linear(d_in: int, d_out: int, *, bias: bool = False,
                 device=None) -> nn.Linear:
    """``nn.Linear`` (weight stored ``(out, in)``, float32) with its memory
    allocated and not initialised: the ``init_*`` functions or
    ``convert.lm_params_from_reference`` fill it."""
    return nn.utils.skip_init(nn.Linear, d_in, d_out, bias=bias,
                              device=device or torch.get_default_device())


@torch.no_grad()
def init_linear_(gen: torch.Generator, lin: nn.Linear) -> nn.Linear:
    """Fill ``lin`` in place: ``dense_init``'s distribution (fan-in scaled
    truncated normal) for the weight, zero bias."""
    truncated_normal_(lin.weight, gen, lin.in_features ** -0.5)
    if lin.bias is not None:
        lin.bias.zero_()
    return lin


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


class RMSNorm(nn.Module):
    """Holds ``scale`` (ones at init)."""

    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device))


class LayerNorm(nn.Module):
    """Holds ``scale`` (ones) and ``bias`` (zeros)."""

    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device))
        self.bias = nn.Parameter(torch.zeros(d, device=device))


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm computed in float32 and cast back to ``x``'s dtype."""
    dtype = x.dtype
    x = x.float()
    var = (x * x).mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * p.scale).to(dtype)


def layernorm(p: LayerNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Layer norm (population variance) in float32, cast back."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * p.scale + p.bias).to(dtype)


def norm_split(ps, xs, *, mesh, axis, eps: float = 1e-5):
    """``rmsnorm`` (``ps[r]`` an ``RMSNorm``) or ``layernorm`` (a
    ``LayerNorm``) of rows whose last dim lies split over ``axis``: rank r
    holds chunk ``axis_index`` of it and the whole scale (and bias). The
    moments come from ``psum``s of (…, 1) float32 partials: the sum of
    squares, or the sum and then the centred sum of squares."""
    d = xs[0].shape[-1] * axis_size(mesh, axis)

    def local(t, r):
        return t.chunk(axis_size(mesh, axis))[axis_index(mesh, r, axis)]

    xf = [x.float() for x in xs]
    if isinstance(ps[0], LayerNorm):
        mu = psum([x.sum(-1, keepdim=True) for x in xf], mesh, axis)
        xf = [x - m / d for x, m in zip(xf, mu)]
    var = psum([x.square().sum(-1, keepdim=True) for x in xf], mesh, axis)
    out = []
    for r, (p, x, v) in enumerate(zip(ps, xf, var)):
        y = x * torch.rsqrt(v / d + eps) * local(p.scale, r)
        if isinstance(p, LayerNorm):
            y = y + local(p.bias, r)
        out.append(y.to(xs[r].dtype))
    return out


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """``(Dh/2,)`` float32 inverse frequencies."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention multiplier ``0.1·mscale·ln(factor) + 1`` (1 for
    ``factor`` <= 1)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_range(dim: int, theta: float, beta_fast: float, beta_slow: float,
               original_max: int) -> tuple[int, int]:
    """``(low, high)``: the frequency indices between which YaRN's ramp runs
    from extrapolated to interpolated (the index at which a frequency turns
    ``beta_fast`` and ``beta_slow`` times over ``original_max`` positions),
    clamped to ``[0, dim - 1]``."""
    def index(turns):
        return (dim * math.log(original_max / (turns * 2 * math.pi))
                / (2 * math.log(theta)))
    low = math.floor(index(beta_fast))
    high = math.ceil(index(beta_slow))
    return max(low, 0), min(high, dim - 1)


def yarn_freqs(dim: int, theta: float, factor: float, beta_fast: float,
               beta_slow: float, original_max: int, device=None) -> torch.Tensor:
    """``(dim/2,)`` float32 YaRN inverse frequencies: ``rope_freqs``
    (extrapolated) below ``low``, divided by ``factor`` (interpolated) above
    ``high``, a linear blend between; plain ``rope_freqs`` for ``factor`` <= 1."""
    extra = rope_freqs(dim, theta, device)
    if factor <= 1:
        return extra
    low, high = yarn_range(dim, theta, beta_fast, beta_slow, original_max)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / max(high - low, 1e-3)).clamp(0, 1)
    return extra / factor * ramp + extra * (1 - ramp)


def rotate(x: torch.Tensor, positions: torch.Tensor, freqs: torch.Tensor,
           mult: float = 1.0) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) or (S,); ``freqs`` (Dh/2,).
    Rotates the (first half, second half) pairs in float32 (the llama/qwen
    convention), cos and sin scaled by ``mult``."""
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs          # (B, S, Dh/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    if mult != 1.0:
        cos, sin = cos * mult, sin * mult
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) or (S,). Plain rope of base
    ``theta`` (``rotate`` with ``rope_freqs``)."""
    return rotate(x, positions, rope_freqs(x.shape[-1], theta, x.device))


def sinusoidal_positions(n_pos: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style sinusoidal table (n_pos, d), float32."""
    half = d // 2
    log_timescale = math.log(10000.0) / (half - 1)
    inv = torch.exp(-log_timescale * torch.arange(half, dtype=torch.float32,
                                                  device=device))
    scaled = torch.arange(n_pos, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


class Embed(nn.Module):
    """Holds the ``(vocab, d)`` token table ``tokens``."""

    def __init__(self, vocab: int, d: int, device=None):
        super().__init__()
        self.tokens = nn.Parameter(torch.empty(vocab, d, device=device))


def embed(p: Embed, tokens: torch.Tensor,
          compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Rows of the table in ``compute_dtype``. Gathering before the cast
    gives the reference's cast-then-gather values without converting the
    whole table per call."""
    return p.tokens[tokens].to(compute_dtype)


def unembed(p_embed: Embed, lm_head, x: torch.Tensor) -> torch.Tensor:
    """Logits; tied embeddings when ``lm_head`` (an ``nn.Linear``) is None.
    Serving keeps the weights in the compute dtype so the casts are no-ops
    (the tied table is 622 MB in bf16 at qwen3-1.7b)."""
    w = p_embed.tokens if lm_head is None else lm_head.weight
    return F.linear(x, w.to(x.dtype))


def linear_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` accumulated and returned in float32 (``w`` an
    ``nn.Linear`` weight, cast to ``x``'s dtype): a row-parallel product's
    partial sum, rounded only once its ranks' partials are added. bf16
    on the card without autograd goes to ``bmm(..., out_dtype=float32)``;
    elsewhere both operands are upcast, which is the same function."""
    w = w.to(x.dtype)
    if (x.is_cuda and x.dtype == torch.bfloat16 and not (
            torch.is_grad_enabled() and (x.requires_grad or w.requires_grad))):
        out = torch.bmm(x.reshape(1, -1, x.shape[-1]), w.t()[None],
                        out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[0])
    return F.linear(x.float(), w.float())


def embed_sharded(ps, tokens, *, mesh, axis, compute_dtype=torch.bfloat16):
    """Vocab-parallel ``embed``: rank ``r`` holds rows ``[c·V/m, (c+1)·V/m)``
    of the table (``c`` its index along ``axis``, ``ps[r].tokens`` already
    gathered over ``data``); it looks up the tokens that fall there, zeros
    elsewhere, and a ``psum`` over ``axis`` adds the one non-zero row
    (exact). ``tokens`` is a ``PerRank``."""
    outs = []
    for r, (p, tok) in enumerate(zip(ps, tokens)):
        vm = p.tokens.shape[0]
        local = tok.long() - axis_index(mesh, r, axis) * vm
        ok = (local >= 0) & (local < vm)
        rows = p.tokens[local.clamp(0, vm - 1)].to(compute_dtype)
        outs.append(rows.masked_fill(~ok[..., None], 0))
    return psum(outs, mesh, axis)


def _relu2(x: torch.Tensor) -> torch.Tensor:
    return torch.square(F.relu(x))


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default form


def activation(name: str):
    """silu, gelu (tanh form) or relu2 (nemotron/minitron's squared ReLU)."""
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu2": _relu2}[name]
