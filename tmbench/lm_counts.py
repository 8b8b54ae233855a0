"""The work an LM training step does, counted from the configuration (an
``MLAConfig``, read by attribute) for the LM cells' per-layer metrics.

Every count is a lower bound of the work the program does: matrix products
only (6 FLOPs a weight a token, forward and backward), the routed experts
from the assignments the step computed (``lm.moe.kept``), the attention
core over the causal half of the score matrix only, and nothing of the
recompute in the backward pass (``remat``). So no share of a peak that
divides one of them by a measured time can pass 100%.
"""
from __future__ import annotations

PEAK_FLOPS = 989.4e12          # H100 SXM, dense bf16 tensor cores


def mla_weights(cfg) -> int:
    """One MLA block's projection weights (wq, wkv_a, wkv_b, wo)."""
    d, h = cfg.d_model, cfg.n_heads
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    return (d * h * qk + d * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
            + cfg.kv_lora_rank * h * (cfg.qk_nope_head_dim + cfg.v_head_dim)
            + h * cfg.v_head_dim * d)


def dense_weights(cfg) -> int:
    """Weights every token meets outside the routed experts: attention,
    the dense blocks' MLPs, the routers and shared experts, the head."""
    d = cfg.d_model
    ffe = cfg.d_ff_expert or cfg.d_ff
    n_moe = cfg.n_layers - cfg.n_dense_layers
    shared = 3 * d * (cfg.d_ff_shared or cfg.n_shared_experts * ffe)
    return (cfg.n_layers * mla_weights(cfg)
            + cfg.n_dense_layers * 3 * d * cfg.d_ff
            + n_moe * (d * cfg.n_experts + shared) + cfg.vocab * d)


def expert_weights(cfg) -> int:
    """One routed expert's weights: what one kept assignment meets."""
    return 3 * cfg.d_model * (cfg.d_ff_expert or cfg.d_ff)


def core_flops(cfg, seq_len: int, n_seqs: int) -> float:
    """The causal attention core, forward and backward, over every layer:
    ``3 · 2·H·(qk_head_dim + v_head_dim) · S(S+1)/2`` a layer a sequence."""
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    pairs = seq_len * (seq_len + 1) / 2
    return 3.0 * 2 * cfg.n_heads * (qk + cfg.v_head_dim) * pairs * cfg.n_layers * n_seqs


def step_flops(cfg, tokens: int, kept: int, seq_len: int) -> float:
    """A training step's counted FLOPs: ``tokens`` of ``seq_len``-long
    sequences, ``kept`` routed assignments computed."""
    return (6.0 * tokens * dense_weights(cfg) + 6.0 * kept * expert_weights(cfg)
            + core_flops(cfg, seq_len, tokens // seq_len))


def mla_flops(cfg, tokens: int, seq_len: int) -> float:
    """The MLA blocks' counted FLOPs, forward and backward: projections and
    the causal core."""
    return (6.0 * tokens * cfg.n_layers * mla_weights(cfg)
            + core_flops(cfg, seq_len, tokens // seq_len))
