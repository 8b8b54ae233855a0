"""Model/shape configuration schema (the port's own copy of
``repro.configs.base``, field for field, so configs compare equal).

``use_scan`` steers only the reference's XLA programs and is ignored by
the port (the reference scans its layer stack; the port always walks an
``nn.ModuleList`` in Python). ``remat`` recomputes each layer group in the
backward pass (``torch.utils.checkpoint``); ``sp_residual`` splits the
residual stream on the sequence over ``model`` in a sharded train step.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned (input-shape) cell."""

    name: str            # train_4k | prefill_32k | decode_32k | long_500k
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int
    # decode shapes: cache length == seq_len (window-limited where noted)

    @property
    def tokens(self) -> int:
        """Tokens in the cell: sequence length times global batch."""
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeSpec("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeSpec("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeSpec("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeSpec("long_500k", "decode", 524288, 1)

LM_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One published LM architecture (fields grouped by family)."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "silu"
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    sliding_window: Optional[int] = None
    # --- moe ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: Optional[int] = None
    d_ff_shared: Optional[int] = None
    capacity_factor: float = 1.25
    moe_dispatch: str = "sort"       # sort | einsum (GShard baseline)
    normalize_topk: bool = True
    # --- ssm (rwkv6) ---
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 32
    # --- hybrid (griffin) ---
    d_rnn: Optional[int] = None
    local_window: Optional[int] = None
    pattern: tuple = ()              # e.g. ("rec", "rec", "attn")
    rnn_chunk: int = 256
    # --- encdec (whisper) ---
    n_enc_layers: int = 0
    enc_seq: int = 0                 # stub frame count (whisper: 1500)
    # --- vlm ---
    n_vision_tokens: int = 0
    # --- numerics / exec ---
    remat: bool = True
    dense_attn_max: int = 8192       # above → blockwise flash-scan attention
    kv_block: int = 512
    # Megatron-SP residual sharding (seq on model between blocks). Worth
    # it for long-seq dense stacks; for MoE the grouped-dispatch layout
    # transition costs an all-to-all per block (§Perf hillclimb B).
    sp_residual: bool = True
    # use_scan=False unrolls all layer/microbatch loops — used by the
    # roofline probe compiles so cost_analysis counts every op exactly
    # (XLA's cost model counts while-loop bodies once; DESIGN.md §6).
    use_scan: bool = True
    # reduced smoke-config factory is per-arch (configs/<id>.py)

    @property
    def head_dim_(self) -> int:
        """``head_dim``, else ``d_model // n_heads``."""
        return self.head_dim or self.d_model // self.n_heads

    @property
    def rwkv_heads(self) -> int:
        """RWKV6 wkv heads: ``d_model // rwkv_head_dim``."""
        return self.d_model // self.rwkv_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (embedding included once if tied)."""
        d, v = self.d_model, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":  # rwkv6
            tm = 4 * d * d + d * d  # r,k,v,g,o
            tm += d * 5 * 32 + 5 * 32 * d + d * 64 + 64 * d  # loras
            cm = 2 * d * self.d_ff + d * d
            return emb + self.n_layers * (tm + cm)
        hd = self.head_dim_
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        if self.family == "moe":
            ffe = self.d_ff_expert or self.d_ff
            moe = self.n_experts * 3 * d * ffe + d * self.n_experts
            if self.n_shared_experts:
                moe += 3 * d * (self.d_ff_shared or self.n_shared_experts * ffe)
            block = attn + moe
            return emb + self.n_layers * block
        if self.family == "hybrid":
            dr = self.d_rnn or d
            rec = 2 * d * dr + 2 * dr * dr + dr * d
            mlp = 3 * d * self.d_ff
            n_attn = self.n_layers // 3
            n_rec = self.n_layers - n_attn
            return emb + n_rec * (rec + mlp) + n_attn * (attn + mlp)
        mlp = (3 if self.act == "silu" else 2) * d * self.d_ff
        layers = self.n_layers + self.n_enc_layers
        return emb + layers * (attn + mlp)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        ffe = self.d_ff_expert or self.d_ff
        hd = self.head_dim_
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        act = self.top_k * 3 * d * ffe + d * self.n_experts
        if self.n_shared_experts:
            act += 3 * d * (self.d_ff_shared or self.n_shared_experts * ffe)
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return emb + self.n_layers * (attn + act)

    def supports_long_context(self) -> bool:
        """Sub-quadratic serving memory (long_500k eligibility)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    def has_decoder(self) -> bool:
        """Every assigned arch has a decode path (whisper's is enc-dec)."""
        return True
