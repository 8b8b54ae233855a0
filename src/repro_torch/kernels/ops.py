"""TM-native wrappers around the kernel primitives — port of
``repro.kernels.ops``.

Each wrapper owns the packing step, so a caller deals in TM tensors (the
config, the TA state, ``(B, o)`` inputs), and routes through
``kernels/backend.resolve``. In the reference these wrappers *force* the
kernel body (compiled Pallas, or the interpreter on a CPU host). In the
port the device of the tensors is what picks the body: a CUDA tensor
launches the hand-written kernel and raises if it cannot build or launch;
a CPU tensor takes the plain body. No wrapper falls back from the kernel to
the plain body. ``backend=`` stays for signature parity and, as
``TMConfig.backend``, takes only ``None`` and ``'auto'``.
"""
from __future__ import annotations

import torch

from repro_torch.core.bitpack import pack_bits, packed_literals
from repro_torch.core.types import (
    TMConfig, TMState, clause_polarity, include_mask)
from repro_torch.kernels import backend as kbackend


def _check_backend(backend: str | None) -> None:
    if backend not in (None, "auto"):
        raise ValueError(
            f"kernel backend {backend!r} is not selectable in the PyTorch "
            "port: the device of the tensors picks the kernel (CUDA kernel "
            "on a CUDA tensor, plain PyTorch on a CPU tensor); pass None or "
            "'auto'")


def _inputs(x, device: torch.device) -> torch.Tensor:
    """(B, o) {0,1} array or tensor → uint8 tensor on ``device``."""
    return torch.as_tensor(x, device=device).to(torch.uint8)


def pack_include(cfg: TMConfig, state: TMState) -> torch.Tensor:
    """(m, n, 2o) include mask → (m, n, W) int32 words (the reference's
    uint32 words, bit for bit)."""
    return pack_bits(include_mask(cfg, state))


def tm_votes_packed(include_packed: torch.Tensor, x, *,
                    backend: str | None = None) -> torch.Tensor:
    """(m, n, W) packed includes + (B, o) inputs → (B, m) int32 votes.

    The cache-taking variant (the bitpack engine's): the packed words are
    kept in step across learning, so nothing repacks the include mask here.
    """
    _check_backend(backend)
    n = include_packed.shape[1]
    pol = torch.where(
        torch.arange(n, device=include_packed.device) < n // 2, 1, -1
    ).to(torch.int32)
    lw = packed_literals(_inputs(x, include_packed.device))
    return kbackend.resolve("clause_votes")(include_packed, lw, pol)


def tm_votes(cfg: TMConfig, state: TMState, x, *,
             backend: str | None = None) -> torch.Tensor:
    """(B, o) inputs → (B, m) int32 votes through the fused eval + vote
    primitive."""
    _check_backend(backend)
    dev = state.ta_state.device
    return kbackend.resolve("clause_votes")(
        pack_include(cfg, state), packed_literals(_inputs(x, dev)),
        clause_polarity(cfg, dev))


def tm_predict(cfg: TMConfig, state: TMState, x, *,
               backend: str | None = None) -> torch.Tensor:
    """(B, o) inputs → (B,) class with the most votes; a tie goes to the
    lowest class index, as ``jnp.argmax`` breaks it."""
    return torch.argmax(tm_votes(cfg, state, x, backend=backend), dim=-1)


def tm_clause_outputs(cfg: TMConfig, state: TMState, x, *,
                      backend: str | None = None) -> torch.Tensor:
    """(B, o) inputs → (B, m, n) int8 clause outputs (learning semantics:
    an empty clause gives 1)."""
    _check_backend(backend)
    dev = state.ta_state.device
    return kbackend.resolve("clause_outputs")(
        pack_include(cfg, state), packed_literals(_inputs(x, dev)))


def tm_ta_update(cfg: TMConfig, ta_row: torch.Tensor, lit: torch.Tensor,
                 clause_out: torch.Tensor, gets_type_i: torch.Tensor,
                 active: torch.Tensor, uniforms: torch.Tensor, *,
                 backend: str | None = None) -> torch.Tensor:
    """Type I / II feedback of one class row → (n, 2o) int16 states.

    Takes the operands in any integer or bool dtype (and the uniforms as
    any float) on one device, and hands the primitive the dtypes its kernel
    takes: int16 states, uint8 literals, int8 clause outputs, bool routing,
    float32 uniforms.
    """
    _check_backend(backend)
    return kbackend.resolve("ta_update")(
        ta_row.to(torch.int16).contiguous(), lit.to(torch.uint8).contiguous(),
        clause_out.to(torch.int8).contiguous(),
        gets_type_i.to(torch.bool).contiguous(),
        active.to(torch.bool).contiguous(),
        uniforms.to(torch.float32).contiguous(),
        n_states=cfg.n_states, s=cfg.s,
        boost_true_positive=cfg.boost_true_positive)
