"""Bit-packed clause evaluation (port of ``repro.kernels.clause_eval``).

    falsified(b, i, j)  ⇔  any_w( inc[i, j, w] & ~lit[b, w] ) != 0
    outputs(b, i, j)    =  [not falsified]                    (empty clause true)
    votes(b, i)         =  Σ_j outputs(b, i, j) · pol(j)

Words are ``torch.int32`` carrying the reference's ``uint32`` bits
(``core/bitpack.py``). Two primitives, each with two bodies:

  * votes (the bitpack engine): :func:`clause_votes_ref`, plain PyTorch, the
    counterpart of the reference's ``_clause_votes_xla``
    (``src/repro/kernels/backend.py:186``); :func:`clause_votes_packed`, the
    hand-written CUDA kernel (``csrc/clause_votes.cu``) that replaces the TPU
    kernel ``_votes_kernel`` (``src/repro/kernels/clause_eval.py:45``).
  * per-clause outputs (the learning round): :func:`clause_outputs_ref`,
    the counterpart of ``_clause_outputs_xla`` (``backend.py:197``);
    :func:`clause_outputs_packed`, the CUDA kernel (``csrc/clause_outputs.cu``)
    that replaces ``_outputs_kernel`` (``clause_eval.py:121``).

CPU tensors take the plain bodies; see each source for the kernel's design.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build


def clause_votes_ref(include_packed: torch.Tensor, lit_packed: torch.Tensor,
                     pol: torch.Tensor) -> torch.Tensor:
    """(m, n, W) include words + (B, W) literal words + (n,) ±1 polarity →
    (B, m) int32 polarity-signed vote sums (plain PyTorch)."""
    viol = include_packed[None] & ~lit_packed[:, None, None]   # (B, m, n, W)
    out = ~(viol != 0).any(dim=-1)                             # (B, m, n)
    return (out.to(torch.int32) * pol.to(torch.int32)).sum(
        -1, dtype=torch.int32)


@functools.cache
def _launcher():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.entry("clause_votes", "clause_votes_launch",
                        [p, p, p, p, i, i, i, i, p])


def _require(cond: bool, msg: str, name: str = "clause_votes_packed") -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def clause_votes_packed(include_packed: torch.Tensor, lit_packed: torch.Tensor,
                        pol: torch.Tensor) -> torch.Tensor:
    """CUDA kernel: (B, m) int32 votes, same contract as
    :func:`clause_votes_ref`.

    Takes ``include_packed`` (m, n, W) int32, ``lit_packed`` (B, W) int32 and
    ``pol`` (n,) int32, all contiguous on one CUDA device, and raises on
    anything else. Launches on the current stream without synchronising.
    """
    inc, lit = include_packed, lit_packed
    _require(inc.is_cuda, f"include words must be a CUDA tensor, got {inc.device}")
    _require(lit.device == inc.device and pol.device == inc.device,
             f"operands on different devices: include {inc.device}, "
             f"literals {lit.device}, pol {pol.device}")
    _require(inc.dtype == torch.int32 and inc.dim() == 3,
             f"include words must be (m, n, W) int32, got "
             f"{tuple(inc.shape)} {inc.dtype}")
    m, n, w = inc.shape
    _require(lit.dtype == torch.int32 and lit.dim() == 2 and lit.shape[1] == w,
             f"literal words must be (B, {w}) int32, got "
             f"{tuple(lit.shape)} {lit.dtype}")
    _require(pol.dtype == torch.int32 and tuple(pol.shape) == (n,),
             f"pol must be ({n},) int32, got {tuple(pol.shape)} {pol.dtype}")
    _require(inc.is_contiguous() and lit.is_contiguous()
             and pol.is_contiguous(), "operands must be contiguous")
    b = lit.shape[0]
    out = torch.zeros((b, m), dtype=torch.int32, device=inc.device)
    if b == 0 or m == 0 or n == 0:
        return out
    launch = _launcher()
    with torch.cuda.device(inc.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = launch(inc.data_ptr(), lit.data_ptr(), pol.data_ptr(),
                      out.data_ptr(), m, n, w, b, stream)
    _build.check(code, "clause_votes")
    clause_votes_packed.launches += 1
    return out


clause_votes_packed.launches = 0


def clause_outputs_ref(include_packed: torch.Tensor,
                       lit_packed: torch.Tensor) -> torch.Tensor:
    """(m, n, W) include words + (B, W) literal words → (B, m, n) int8
    clause outputs, 1 where no included literal is false (an empty clause
    gives 1; plain PyTorch)."""
    viol = include_packed[None] & ~lit_packed[:, None, None]   # (B, m, n, W)
    return (~(viol != 0).any(dim=-1)).to(torch.int8)


@functools.cache
def _outputs_launcher():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.entry("clause_outputs", "clause_outputs_launch",
                        [p, p, p, ctypes.c_longlong, i, i, p])


def clause_outputs_packed(include_packed: torch.Tensor,
                          lit_packed: torch.Tensor) -> torch.Tensor:
    """CUDA kernel: (B, m, n) int8 clause outputs, same contract as
    :func:`clause_outputs_ref`.

    Takes ``include_packed`` (m, n, W) int32 and ``lit_packed`` (B, W) int32,
    both contiguous on one CUDA device, and raises on anything else.
    Launches on the current stream without synchronising.
    """
    inc, lit = include_packed, lit_packed
    need = functools.partial(_require, name="clause_outputs_packed")
    need(inc.is_cuda, f"include words must be a CUDA tensor, got {inc.device}")
    need(lit.device == inc.device,
         f"operands on different devices: include {inc.device}, "
         f"literals {lit.device}")
    need(inc.dtype == torch.int32 and inc.dim() == 3,
         f"include words must be (m, n, W) int32, got "
         f"{tuple(inc.shape)} {inc.dtype}")
    m, n, w = inc.shape
    need(lit.dtype == torch.int32 and lit.dim() == 2 and lit.shape[1] == w,
         f"literal words must be (B, {w}) int32, got "
         f"{tuple(lit.shape)} {lit.dtype}")
    need(inc.is_contiguous() and lit.is_contiguous(),
         "operands must be contiguous")
    b = lit.shape[0]
    if w == 0:   # no literals: every clause is empty, hence true
        return torch.ones((b, m, n), dtype=torch.int8, device=inc.device)
    out = torch.empty((b, m, n), dtype=torch.int8, device=inc.device)
    if out.numel() == 0:
        return out
    launch = _outputs_launcher()
    with torch.cuda.device(inc.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = launch(inc.data_ptr(), lit.data_ptr(), out.data_ptr(),
                      out.numel(), m * n, w, stream)
    _build.check(code, "clause_outputs")
    clause_outputs_packed.launches += 1
    return out


clause_outputs_packed.launches = 0
