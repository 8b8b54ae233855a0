"""deepseek-v2-lite [moe, MLA]: 27 layers, d_model 2048, 16 heads; latent
attention (kv_lora_rank 512, qk_nope 128 + qk_rope 64, v 128, no q-LoRA)
with YaRN rope (factor 40 over 4096 original positions); one dense layer of
10,944, then 26 MoE layers of 64 routed experts of 1,408 (softmax top-6, not
renormalised) and 2 shared ones, ungated; vocab 102,400, untied
(hf:deepseek-ai/DeepSeek-V2-Lite config.json). A port-only architecture:
not in ``ARCHS``.
"""
from repro_torch.configs.base import MLAConfig

CONFIG = MLAConfig(
    name="deepseek-v2-lite", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=10944,
    vocab=102400, head_dim=128, rope_theta=1e4, norm_eps=1e-6,
    n_experts=64, top_k=6, n_shared_experts=2, d_ff_expert=1408,
    normalize_topk=False, sp_residual=False,
    kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
    v_head_dim=128, rope_factor=40.0, beta_fast=32.0, beta_slow=1.0,
    mscale=0.707, mscale_all_dim=0.707, original_max_positions=4096,
    n_dense_layers=1,
)
