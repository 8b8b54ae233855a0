"""Bit-packing of literal/include vectors into 32-bit words.

    clause falsified  ⇔  any_w( include_w & ~literal_w ) != 0

The reference (``repro.core.bitpack``) packs into ``uint32``. The port
carries the same words as ``torch.int32`` — bit-identical, so
``words.numpy().view(np.uint32)`` equals the reference — because PyTorch's
CPU ``uint32`` lacks ``~``, ``<<`` and ``index_add_``. Packing sums the
shifted bits in int64 and wraps bit 31 explicitly.
"""
from __future__ import annotations

import torch

WORD = 32


def n_words(n_bits: int) -> int:
    """Words needed for ``n_bits`` bits."""
    return (n_bits + WORD - 1) // WORD


def _shifts(device) -> torch.Tensor:
    return torch.arange(WORD, dtype=torch.int64, device=device)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(…, K) {0,1} → (…, ceil(K/32)) int32 words (little-endian bit order)."""
    k = bits.shape[-1]
    w = n_words(k)
    pad = w * WORD - k
    b = bits.to(torch.int64)
    if pad:
        b = torch.nn.functional.pad(b, (0, pad))
    b = b.reshape(bits.shape[:-1] + (w, WORD))
    v = (b << _shifts(bits.device)).sum(dim=-1)          # in [0, 2³²)
    v = torch.where(v >= 2**31, v - 2**32, v)            # wrap bit 31
    return v.to(torch.int32)


def unpack_bits(words: torch.Tensor, n_bits: int) -> torch.Tensor:
    """(…, W) int32 words → (…, n_bits) uint8."""
    v = words.to(torch.int64) & 0xFFFFFFFF
    bits = (v[..., None] >> _shifts(words.device)) & 1
    bits = bits.reshape(words.shape[:-1] + (words.shape[-1] * WORD,))
    return bits[..., :n_bits].to(torch.uint8)


def packed_literals(x: torch.Tensor) -> torch.Tensor:
    """(…, o) {0,1} features → (…, ceil(2o/32)) packed [x, ¬x] literals."""
    x = x.to(torch.uint8)
    return pack_bits(torch.cat([x, 1 - x], dim=-1))
