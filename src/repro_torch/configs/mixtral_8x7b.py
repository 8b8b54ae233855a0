"""mixtral-8x7b [moe]: 8 experts top-2 + SWA (arXiv:2401.04088).

32L, d_model 4096, 32 heads (GQA kv=8), expert d_ff 14336, vocab 32000,
sliding window 4096 ⇒ rolling-buffer decode cache ⇒ long_500k eligible.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    d_ff_expert=14336, vocab=32000, head_dim=128, rope_theta=1e6,
    n_experts=8, top_k=2, sliding_window=4096,
    sp_residual=False,  # §Perf hillclimb B: SP↔group all-to-alls cost more than SP saves for MoE
)
