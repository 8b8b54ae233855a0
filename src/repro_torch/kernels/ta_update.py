"""Type I / Type II feedback of one class round (port of
``repro.kernels.ta_update``).

Given one class row's TA states, the literals, the round's clause outputs
and its per-clause routing (update gate ``active``, Type I or Type II), apply
the per-(clause, literal) transitions and clip to ``[1, 2N]``. Two bodies:

  * :func:`ta_update_ref` — plain PyTorch, the counterpart of the
    reference's ``_ta_update_xla`` (``src/repro/kernels/backend.py:205``).
    CPU tensors take it.
  * :func:`ta_update` — the hand-written CUDA kernel (``csrc/ta_update.cu``)
    that replaces the TPU kernel ``_update_kernel``
    (``src/repro/kernels/ta_update.py:35``): one memory-bound elementwise
    pass in 16-byte loads; see the source for the design.

Both take the uniforms as an operand, so injected draws reach them, and an
optional ``out`` (which may be ``ta_row`` itself: the round then updates the
row in place).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build


def thresholds(s: float, boost_true_positive: bool) -> tuple[float, float]:
    """``(inv_s, p_reward)`` as the float32 values the reference compares
    against: the double values ``1/s`` and ``1 - 1/s`` (1.0 under
    ``boost_true_positive``) rounded once to float32, as JAX's weak-typed
    Python floats are. Float32 arithmetic on ``s`` would land one ulp away
    for some ``s`` (``1.0f/3.9f``, ``1.0f - 1.0f/3.0f``)."""
    inv_s = 1.0 / s
    p_reward = 1.0 if boost_true_positive else 1.0 - inv_s
    return float(np.float32(inv_s)), float(np.float32(p_reward))


def ta_update_ref(ta_row: torch.Tensor, lit: torch.Tensor,
                  clause_out: torch.Tensor, gets_type_i: torch.Tensor,
                  active: torch.Tensor, uniforms: torch.Tensor, *,
                  n_states: int, s: float, boost_true_positive: bool = False,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """(n, 2o) int16 states + (2o,) literals + (n,) clause outputs, Type I
    routing and update gates + (n, 2o) float32 uniforms → (n, 2o) int16
    (plain PyTorch). Written into ``out`` when given."""
    inv_s, p_reward = thresholds(s, boost_true_positive)
    include = ta_row > n_states
    c1 = (clause_out == 1)[:, None]
    l1 = (lit == 1)[None, :]
    reward = c1 & l1 & (uniforms < p_reward)
    penalty = (~c1 | ~l1) & (uniforms < inv_s)
    d1 = reward.to(torch.int16) - penalty.to(torch.int16)
    d2 = (c1 & ~l1 & ~include).to(torch.int16)
    act = active.to(torch.bool)[:, None]
    t1 = gets_type_i.to(torch.bool)[:, None]
    delta = torch.where(act & t1, d1, torch.where(act & ~t1, d2, 0))
    new = torch.clamp(ta_row.to(torch.int16) + delta, 1, 2 * n_states).to(
        torch.int16)
    if out is None:
        return new
    return out.copy_(new)


@functools.cache
def _launcher():
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.entry("ta_update", "ta_update_launch",
                        [p, p, p, p, p, p, p, i, i, i, f, f, i, p])


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ta_update: {msg}")


def ta_update(ta_row: torch.Tensor, lit: torch.Tensor,
              clause_out: torch.Tensor, gets_type_i: torch.Tensor,
              active: torch.Tensor, uniforms: torch.Tensor, *,
              n_states: int, s: float, boost_true_positive: bool = False,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """CUDA kernel: (n, 2o) int16 updated states, same contract as
    :func:`ta_update_ref`.

    Takes ``ta_row`` (n, 2o) int16, ``lit`` (2o,) uint8, ``clause_out`` (n,)
    int8, ``gets_type_i`` and ``active`` (n,) bool, ``uniforms`` (n, 2o)
    float32 and, optionally, ``out`` (n, 2o) int16 (``ta_row`` itself for an
    in-place round), all contiguous on one CUDA device; raises on anything
    else. Launches on the current stream without synchronising.
    """
    _require(ta_row.is_cuda, f"ta_row must be a CUDA tensor, got {ta_row.device}")
    _require(ta_row.dtype == torch.int16 and ta_row.dim() == 2,
             f"ta_row must be (n, 2o) int16, got {tuple(ta_row.shape)} "
             f"{ta_row.dtype}")
    n, L = ta_row.shape
    operands = {"lit": (lit, torch.uint8, (L,)),
                "clause_out": (clause_out, torch.int8, (n,)),
                "gets_type_i": (gets_type_i, torch.bool, (n,)),
                "active": (active, torch.bool, (n,)),
                "uniforms": (uniforms, torch.float32, (n, L))}
    if out is not None:
        operands["out"] = (out, torch.int16, (n, L))
    for name, (t, dtype, shape) in operands.items():
        _require(t.device == ta_row.device,
                 f"operands on different devices: ta_row {ta_row.device}, "
                 f"{name} {t.device}")
        _require(t.dtype == dtype and tuple(t.shape) == shape,
                 f"{name} must be {shape} {dtype}, got {tuple(t.shape)} "
                 f"{t.dtype}")
    tensors = [ta_row] + [t for t, _, _ in operands.values()]
    _require(all(t.is_contiguous() for t in tensors),
             "operands must be contiguous")
    if out is None:
        out = torch.empty_like(ta_row)
    if out.numel() == 0:
        return out
    inv_s, p_reward = thresholds(s, boost_true_positive)
    vec = int(L % 8 == 0 and lit.data_ptr() % 8 == 0
              and all(t.data_ptr() % 16 == 0 for t in (ta_row, uniforms, out)))
    launch = _launcher()
    with torch.cuda.device(ta_row.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = launch(ta_row.data_ptr(), lit.data_ptr(), clause_out.data_ptr(),
                      gets_type_i.data_ptr(), active.data_ptr(),
                      uniforms.data_ptr(), out.data_ptr(), n, L, n_states,
                      inv_s, p_reward, vec, stream)
    _build.check(code, "ta_update")
    ta_update.launches += 1
    return out


ta_update.launches = 0
