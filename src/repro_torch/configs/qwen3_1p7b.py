"""qwen3-1.7b [dense]: qk_norm + GQA (hf:Qwen/Qwen3-1.7B family).

28L, d_model 2048, 16 heads (GQA kv=8), d_ff 6144, vocab 151936,
head_dim 128, per-head RMS qk-norm, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=6144,
    vocab=151936, head_dim=128, qk_norm=True, rope_theta=1e6,
    tie_embeddings=True,
)
