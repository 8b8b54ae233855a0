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

    # What the LM blocks read of every config, ``MLAConfig`` overriding it;
    # not dataclass fields (unannotated), so ``asdict`` stays as it is.
    n_dense_layers = 0   # leading dense blocks before the MoE blocks
    shared_gate = True   # the shared experts' output behind a sigmoid gate

    @property
    def n_held(self) -> int:
        """Experts a MoE layer holds: all of them."""
        return self.n_experts

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


@dataclasses.dataclass(frozen=True)
class MLAConfig(ModelConfig):
    """A DeepSeek-V2-style MoE decoder (arXiv:2405.04434 §2.1): multi-head
    latent attention with YaRN rope, ``n_dense_layers`` leading dense
    blocks (width ``d_ff``), then MoE blocks (experts of ``d_ff_expert``).
    A port-only config type: ``ModelConfig``'s fields, and so every other
    architecture's config, stay as they are.

    Attention per token: ``q = wq h`` split per head into ``qk_nope_head_dim``
    + ``qk_rope_head_dim``; ``[c; k_R] = wkv_a h`` with ``c`` the
    ``kv_lora_rank``-wide latent (RMS-normed) and ``k_R`` one rope key shared
    by every head; ``[k_C; v] = wkv_b c`` per head. ``n_kv_heads`` is
    ``n_heads`` and ``head_dim`` the value head dim.

    YaRN (arXiv:2309.00071): ``rope_factor`` > 1 blends each rope frequency
    between its extrapolated and its ``1/rope_factor`` interpolated value over
    the frequency indices set by ``beta_fast`` / ``beta_slow`` at
    ``original_max_positions``; the softmax scale is ``qk_head_dim^-0.5 ·
    m(mscale_all_dim)^2`` and the cos/sin multiplier ``m(mscale) /
    m(mscale_all_dim)``, with ``m(s) = 0.1·s·ln(rope_factor) + 1``.

    The shared experts' output is added ungated (DeepSeek's; Qwen's
    ``ModelConfig`` MoE gates it). ``experts_held``: how many of the
    router's ``n_experts`` this layer holds and computes (experts 0 to
    ``experts_held - 1``, as rank 0 of an expert-parallel deployment holds
    them; None: all); the router and its top-k stay over all
    ``n_experts``."""

    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_factor: float = 1.0
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 1.0
    original_max_positions: int = 4096
    n_dense_layers: int = 0
    experts_held: Optional[int] = None
    shared_gate = False   # DeepSeek adds the shared experts' output ungated

    @property
    def qk_head_dim(self) -> int:
        """Query/key head dim: the non-rope part plus the rope part."""
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def n_held(self) -> int:
        """Experts this layer holds (all unless ``experts_held`` is set)."""
        return self.n_experts if self.experts_held is None else self.experts_held

    def _mla_params(self) -> int:
        """One MLA block's projection weights (no norms)."""
        d, h = self.d_model, self.n_heads
        r, dr = self.kv_lora_rank, self.qk_rope_head_dim
        return (d * h * self.qk_head_dim + d * (r + dr)
                + r * h * (self.qk_nope_head_dim + self.v_head_dim)
                + h * self.v_head_dim * d)

    def _norms(self) -> int:
        """Norm scales: two a block and the latent's, and the final one."""
        return self.n_layers * (2 * self.d_model + self.kv_lora_rank) + self.d_model

    def _shared(self) -> int:
        ffe = self.d_ff_expert or self.d_ff
        return 3 * self.d_model * (self.d_ff_shared or self.n_shared_experts * ffe)

    def param_count(self) -> int:
        """Parameters held: embeddings, every block (a MoE block's router
        over all experts, its held experts only), norms included."""
        d, ffe = self.d_model, self.d_ff_expert or self.d_ff
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        n_moe = self.n_layers - self.n_dense_layers
        moe = (d * self.n_experts + self.n_held * 3 * d * ffe
               + (self._shared() if self.n_shared_experts else 0))
        return (emb + self.n_layers * self._mla_params()
                + self.n_dense_layers * 3 * d * self.d_ff + n_moe * moe
                + self._norms())

    def active_param_count(self) -> int:
        """Parameters touched per token: ``top_k`` routed experts of the
        router's ``n_experts`` (wherever they are held), the shared ones,
        the router, attention, the dense blocks, embeddings and norms."""
        d, ffe = self.d_model, self.d_ff_expert or self.d_ff
        held = self.n_held * 3 * d * ffe
        return (self.param_count()
                - (self.n_layers - self.n_dense_layers)
                * (held - self.top_k * 3 * d * ffe))
