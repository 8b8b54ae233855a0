"""whisper-medium [audio]: enc-dec, conv frontend stubbed (arXiv:2212.04356).

24 encoder + 24 decoder layers, d_model 1024, 16 heads (kv=16), d_ff 4096,
vocab 51865, 1500 encoder frames, LayerNorm + GELU, tied unembedding.
Prefill/decode shape cells exercise the decoder (DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865, head_dim=64, norm="layernorm", act="gelu",
    tie_embeddings=True, enc_seq=1500,
)
