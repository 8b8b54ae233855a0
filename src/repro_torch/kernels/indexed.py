"""Falsification-index scoring: matmul-form Eq. 4 (port of
``repro.kernels.indexed``).

``pos (m, n, 2o)`` is ``NA`` exactly where clause j excludes literal k, so
the membership mask ``pos != NA`` is the include mask and Eq. 4 becomes

    falsified(b, i, j)  =  Σ_k false_lit(b, k) · member(i, j, k)  >  0
    votes(b, i)         =  -Σ_j falsified(b, i, j) · pol(j)

Two bodies:

  * :func:`indexed_votes_ref` — plain PyTorch, the counterpart of the
    reference's ``indexed_votes_xla`` (a float32 product over 0/1 operands;
    hit counts ≤ 2o < 2²⁴ are exact). CPU tensors take it.
  * :func:`indexed_votes` — the hand-written CUDA kernel
    (``csrc/indexed_votes.cu``) that replaces the TPU kernel
    ``_indexed_votes_kernel`` (``src/repro/kernels/indexed.py:103``). It is
    bounded by reading ``pos`` and reads it once per 32 samples; see the
    source for the design.

``index_update`` (batched event replay) comes with training, in the next
slice of the port.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

# Mirrors core.indexing.NA — the ClauseIndex layout's "excluded" sentinel.
NA = -1


def indexed_votes_ref(pos: torch.Tensor, lit: torch.Tensor,
                      pol: torch.Tensor) -> torch.Tensor:
    """(m, n, 2o) positions + (B, 2o) literals + (n,) ±1 polarity →
    (B, m) int32 vote sums ``-Σ_{j falsified} pol_j`` (plain PyTorch)."""
    m, n, L = pos.shape
    member = (pos != NA).reshape(m * n, L)
    false_lit = (lit == 0)
    hits = torch.matmul(false_lit.to(torch.float32),
                        member.to(torch.float32).T)          # (B, m·n)
    falsified = (hits > 0).reshape(-1, m, n)
    return -(falsified.to(torch.int32) * pol.to(torch.int32)).sum(
        -1, dtype=torch.int32)


@functools.cache
def _launcher():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.entry("indexed_votes", "indexed_votes_launch",
                        [p, p, p, p, p, i, i, i, i, i, p])


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"indexed_votes: {msg}")


def indexed_votes(pos: torch.Tensor, lit: torch.Tensor,
                  pol: torch.Tensor) -> torch.Tensor:
    """CUDA kernel: (B, m) int32 falsification votes, same contract as
    :func:`indexed_votes_ref`.

    Takes ``pos`` (m, n, 2o) int32, ``lit`` (B, 2o) uint8 and ``pol`` (n,)
    int32, all contiguous on one CUDA device, and raises on anything else.
    Launches on the current stream without synchronising.
    """
    _require(pos.is_cuda, f"pos must be a CUDA tensor, got {pos.device}")
    _require(lit.device == pos.device and pol.device == pos.device,
             f"operands on different devices: pos {pos.device}, "
             f"lit {lit.device}, pol {pol.device}")
    _require(pos.dtype == torch.int32 and pos.dim() == 3,
             f"pos must be (m, n, 2o) int32, got {tuple(pos.shape)} {pos.dtype}")
    m, n, L = pos.shape
    _require(lit.dtype == torch.uint8 and lit.dim() == 2 and lit.shape[1] == L,
             f"lit must be (B, {L}) uint8, got {tuple(lit.shape)} {lit.dtype}")
    _require(pol.dtype == torch.int32 and tuple(pol.shape) == (n,),
             f"pol must be ({n},) int32, got {tuple(pol.shape)} {pol.dtype}")
    _require(pos.is_contiguous() and lit.is_contiguous()
             and pol.is_contiguous(), "operands must be contiguous")
    b = lit.shape[0]
    out = torch.zeros((b, m), dtype=torch.int32, device=pos.device)
    if b == 0 or m == 0 or n == 0 or L == 0:
        return out
    fl = torch.empty(((b + 31) // 32, L), dtype=torch.int32, device=pos.device)
    vec4 = int(L % 4 == 0 and pos.data_ptr() % 16 == 0)
    launch = _launcher()
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = launch(pos.data_ptr(), lit.data_ptr(), pol.data_ptr(),
                      fl.data_ptr(), out.data_ptr(), m, n, L, b, vec4, stream)
    _build.check(code, "indexed_votes")
    indexed_votes.launches += 1
    return out


indexed_votes.launches = 0
