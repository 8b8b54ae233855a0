"""recurrentgemma-9b [hybrid]: RG-LRU + local attention 1:2
(arXiv:2402.19427). 38L, d_model 4096, 16 heads (MQA kv=1), d_ff 12288,
vocab 256000, local window 2048, pattern (rec, rec, attn) — 12 groups + 2
trailing recurrent blocks. Windowed cache + O(d_rnn) state ⇒ long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, d_ff=12288,
    vocab=256000, head_dim=256, d_rnn=4096, local_window=2048,
    pattern=("rec", "rec", "attn"), rnn_chunk=256, tie_embeddings=True,
)
