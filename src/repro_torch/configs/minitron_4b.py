"""minitron-4b [dense]: pruned nemotron (arXiv:2407.14679).

32L, d_model 3072, 24 heads (GQA kv=8), d_ff 9216, vocab 256000.
Nemotron-style non-gated squared-ReLU MLP.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, d_ff=9216,
    vocab=256000, head_dim=128, act="relu2", rope_theta=1e4,
)
