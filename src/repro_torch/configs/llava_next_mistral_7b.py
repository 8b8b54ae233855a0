"""llava-next-mistral-7b [vlm]: Mistral-7B backbone + anyres vision stub.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified] — 32L, d_model 4096,
32 heads (GQA kv=8), d_ff 14336, vocab 32000. The anyres tiling frontend is
a stub per the assignment: input_specs provides pre-projected patch
embeddings (2880 = 576 base + 4×576 tiles).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=32000, head_dim=128, rope_theta=1e6, n_vision_tokens=2880,
)
