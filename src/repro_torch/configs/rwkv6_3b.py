"""rwkv6-3b [ssm]: Finch — data-dependent decay, attention-free
(arXiv:2404.05892). 32L, d_model 2560, d_ff 8960, vocab 65536,
head_size 64 (40 wkv heads). O(1)-per-token state ⇒ long_500k eligible.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, d_ff=8960,
    vocab=65536, rwkv_head_dim=64, rwkv_chunk=32, norm="layernorm",
)
