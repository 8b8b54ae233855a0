"""qwen2-moe-a2.7b [moe]: 4 shared + 60 routed top-4
(hf:Qwen/Qwen1.5-MoE-A2.7B). 24L, d_model 2048, 16 heads (kv=16),
expert d_ff 1408 (shared 5632), vocab 151936, QKV bias.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    d_ff_expert=1408, d_ff_shared=5632, vocab=151936, head_dim=128,
    qkv_bias=True, rope_theta=1e6, n_experts=60, top_k=4,
    n_shared_experts=4, normalize_topk=False,
    sp_residual=False,  # §Perf hillclimb B: SP↔group all-to-alls cost more than SP saves for MoE
)
