"""The causal attention core of multi-head latent attention (MLA), forward
and backward: ``softmax(scale · q kᵀ, causal by position) v`` for
``models/attention.py``'s ``mla_attend``, with q and k of one head dim and v
of another (DeepSeek-V2: 192 and 128).

:func:`attention_fwd` / :func:`attention_bwd` launch the hand-written CUDA
kernels (``csrc/mla_attention.cu``; see the source for the design): a tiled
online softmax in float32 (running max and denominator, in base 2) that
saves the logsumexp, and a backward that recomputes P from it and forms
``dS = P ∘ (dP − D)`` with ``D = rowsum(dO ∘ O)``; the S × S scores never
go to device memory. :class:`MLACore` (a ``torch.autograd.Function``)
wraps them; :func:`mla_attention` takes CUDA bf16 operands only and raises
on anything else (``mla_attend`` keeps ``_sdpa`` for CPU and float32 ones).
``tests/test_torch_mla.py`` holds the same algorithm in plain PyTorch
against autograd through ``_sdpa``.

The function is ``_sdpa(q, k, v, _mask(pos, pos, "causal", None), scale)``
exactly: a key at ``pos[c]`` is allowed to a query at ``pos[r]`` iff ``0 ≤
pos[c] ≤ pos[r]``; a masked score is ``attention.NEG_INF`` (so a row with
no allowed key, ``pos[r] < 0``, attends uniformly to all S keys, as
``_sdpa``'s does). A (query tile, key tile) pair is skipped when every query
position of the tile is ≥ 0 and the key tile's smallest position exceeds
the query tile's largest: exact for any positions, half the work for
``arange``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

QK_DIM, V_DIM = 192, 128         # the one head-dim pair the kernels compile
GRANULE = 64                     # positions per granule of the tile stats
LOG2E = math.log2(math.e)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"mla_attention: {msg}")


def _rows_aligned(t: torch.Tensor) -> bool:
    """16-byte rows: a unit last stride, the others multiples of 8, the
    start 16-byte aligned."""
    return (t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


def check_operands(q, k, v, pos) -> None:
    """Raise unless the kernels take these CUDA operands: bf16 q, k (B, S,
    H, 192) and v (B, S, H, 128) with 16-byte rows, and (B, S) positions, on
    one device."""
    _require(q.is_cuda, f"q must be a CUDA tensor, got {q.device}")
    for name, t in (("k", k), ("v", v), ("pos", pos)):
        _require(t.device == q.device,
                 f"operands on different devices: q {q.device}, {name} {t.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _require(t.dtype == torch.bfloat16,
                 f"{name} must be bfloat16, got {t.dtype}")
        _require(t.dim() == 4, f"{name} must be (B, S, H, D), got {tuple(t.shape)}")
    _require(q.shape[-1] == QK_DIM and v.shape[-1] == V_DIM,
             f"head dims must be q/k {QK_DIM} and v {V_DIM} (the one pair "
             f"compiled), got {q.shape[-1]} and {v.shape[-1]}")
    _require(k.shape == q.shape and v.shape[:3] == q.shape[:3],
             f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    _require(tuple(pos.shape) == tuple(q.shape[:2]),
             f"pos must be (B, S) = {tuple(q.shape[:2])}, got {tuple(pos.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _require(t.stride(-1) == 1,
                 f"{name} must have a unit last stride, got strides {t.stride()}")
        _require(_rows_aligned(t),
                 f"{name}'s rows must be 16-byte aligned (strides {t.stride()})")
    _require(q.shape[0] * q.shape[1] * q.shape[2] > 0, "empty operands")


@functools.cache
def _fwd_launcher():
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    return _build.entry("mla_attention", "mla_attention_fwd_launch",
                        [p, p, p] + [ll] * 9 + [p, p, p, p, i, i, i, f, p])


@functools.cache
def _bwd_launcher():
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    return _build.entry("mla_attention", "mla_attention_bwd_launch",
                        [p, p, p, p] + [ll] * 12 + [p] * 8 + [i, i, i, f, f, p])


def attention_fwd(q, k, v, pos, scale: float):
    """CUDA kernels (granule stats, then attention): out (B, S, H, 128)
    bf16; lse (B, H, S) float32, the row max plus log2 of the denominator
    in ``scale · log2 e`` units, ``attention.NEG_INF`` for a row with no
    allowed key; stats (B, ceil(S/64), 2) int32, each granule's smallest
    and largest position. ``pos`` (B, S) int32 contiguous. Launches on the current
    stream without synchronising."""
    check_operands(q, k, v, pos)
    _require(pos.dtype == torch.int32 and pos.is_contiguous(),
             f"pos must be contiguous int32, got {pos.dtype}")
    b, s, h, _ = q.shape
    out = torch.empty((b, s, h, V_DIM), dtype=torch.bfloat16, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    stats = torch.empty((b, -(-s // GRANULE), 2), dtype=torch.int32, device=q.device)
    launch = _fwd_launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), *q.stride()[:3],
                      *k.stride()[:3], *v.stride()[:3], pos.data_ptr(),
                      stats.data_ptr(), out.data_ptr(), lse.data_ptr(), b, s, h,
                      scale * LOG2E, stream)
    _build.check(code, "mla_attention")
    attention_fwd.launches += 1
    return out, lse, stats


def attention_bwd(q, k, v, pos, stats, out, lse, dout, scale: float):
    """CUDA kernels (a memset, D = rowsum(dO ∘ O), the gradients): (dq, dk,
    dv) bf16 from the operands and results of :func:`attention_fwd`. P is
    recomputed as ``exp2(t − lse)`` (``1/S`` in a row with no allowed key),
    ``dS = P (dP − D) · scale`` is zero where masked, and P and dS are
    rounded to bf16 for the products. dq accumulates in a float32 buffer by
    atomics (its sums' order varies from run to run)."""
    check_operands(q, k, v, pos)
    _require(dout.dtype == torch.bfloat16 and dout.shape == out.shape,
             f"dout must be bf16 {tuple(out.shape)}, got {dout.dtype} "
             f"{tuple(dout.shape)}")
    if not _rows_aligned(dout):
        dout = dout.contiguous()
    b, s, h, _ = q.shape
    dq = torch.empty((b, s, h, QK_DIM), dtype=torch.float32, device=q.device)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    dk = torch.empty((b, s, h, QK_DIM), dtype=torch.bfloat16, device=q.device)
    dv = torch.empty((b, s, h, V_DIM), dtype=torch.bfloat16, device=q.device)
    launch = _bwd_launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                      *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                      *dout.stride()[:3], pos.data_ptr(), stats.data_ptr(),
                      out.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                      dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, h, scale,
                      scale * LOG2E, stream)
    _build.check(code, "mla_attention")
    attention_bwd.launches += 1
    return dq.to(torch.bfloat16), dk, dv


attention_fwd.launches = 0
attention_bwd.launches = 0


class MLACore(torch.autograd.Function):
    """The core with its backward, by the kernels. Saves q, k, v, the
    positions, the output, the logsumexp and the kernels' granule stats."""

    @staticmethod
    def forward(ctx, q, k, v, pos, scale):
        out, lse, stats = attention_fwd(q, k, v, pos, scale)
        ctx.save_for_backward(q, k, v, pos, out, lse, stats)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, pos, out, lse, stats = ctx.saved_tensors
        grads = attention_bwd(q, k, v, pos, stats, out, lse, dout.to(out.dtype),
                              ctx.scale)
        return (*grads, None, None)


def mla_attention(q, k, v, pos, scale: float):
    """``softmax(scale · q kᵀ, causal by pos) v``: q, k (B, S, H, 192), v
    (B, S, H, 128) CUDA bf16 with 16-byte rows, pos (B, S) integer → (B, S,
    H, 128), differentiable in q, k and v. Raises on any other operands."""
    return MLACore.apply(q, k, v, pos.to(torch.int32).contiguous(), float(scale))
