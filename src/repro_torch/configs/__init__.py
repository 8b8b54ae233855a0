"""Config registry: the assigned LM architectures (the port's own copy of
``repro.configs``) and, in ``configs/tm.py``, the paper's TM configurations.

Every architecture's config is data and is registered here;
``SKIPPED_CELLS`` reads every config. ``ARCHS`` is the reference's list;
``PORT_ARCHS`` are architectures only the port runs (``MLAConfig``), which
``get_config`` and the launch CLIs accept too.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import (
    DECODE_32K,
    LM_SHAPES,
    LONG_500K,
    PREFILL_32K,
    TRAIN_4K,
    MLAConfig,
    ModelConfig,
    ShapeSpec,
)

_ARCH_MODULES = {
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "whisper-medium": "whisper_medium",
    "qwen3-1.7b": "qwen3_1p7b",
    "granite-8b": "granite_8b",
    "qwen2-72b": "qwen2_72b",
    "minitron-4b": "minitron_4b",
    "rwkv6-3b": "rwkv6_3b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "mixtral-8x7b": "mixtral_8x7b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2p7b",
}

ARCHS = tuple(_ARCH_MODULES)

# architectures the port runs that the reference has no config for
_PORT_ARCH_MODULES = {
    "deepseek-v2-lite": "deepseek_v2_lite",
}

PORT_ARCHS = tuple(_PORT_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    """The published config of architecture ``name`` (``ARCHS`` or
    ``PORT_ARCHS``)."""
    module = _ARCH_MODULES.get(name) or _PORT_ARCH_MODULES.get(name)
    if module is None:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{sorted(_ARCH_MODULES) + sorted(_PORT_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{module}").CONFIG


def get_shape(name: str) -> ShapeSpec:
    """One of the four ``LM_SHAPES`` cells by name."""
    shapes = {s.name: s for s in LM_SHAPES}
    return shapes[name]


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    upd: dict = dict(
        d_model=64, n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 2),
        head_dim=16, d_ff=128, vocab=128, remat=False, dense_attn_max=8192,
        kv_block=16,
    )
    if cfg.family == "encdec":
        upd.update(n_layers=2, n_enc_layers=2, enc_seq=8)
    elif cfg.family == "hybrid":
        upd.update(n_layers=5, d_rnn=64, local_window=8, rnn_chunk=4,
                   head_dim=16, n_kv_heads=1)
    elif cfg.family == "ssm":
        upd.update(n_layers=2, rwkv_head_dim=16, rwkv_chunk=4,
                   n_heads=4, n_kv_heads=4)
    elif cfg.family == "moe":
        upd.update(n_layers=2, n_experts=4, top_k=2,
                   d_ff_expert=32,
                   d_ff_shared=64 if cfg.n_shared_experts else None,
                   n_shared_experts=min(cfg.n_shared_experts, 2))
    elif cfg.family == "vlm":
        upd.update(n_layers=2, n_vision_tokens=4)
    else:
        upd.update(n_layers=2)
    if cfg.sliding_window:
        upd["sliding_window"] = 8
    if isinstance(cfg, MLAConfig):
        # every kind of layer: a dense block, MoE blocks holding half of
        # the router's experts; the published head dims (q/k 128 + 64, v
        # 128), the one pair the attention core's CUDA kernel compiles
        upd.update(n_layers=3, n_dense_layers=1, n_kv_heads=4,
                   head_dim=cfg.v_head_dim, kv_lora_rank=32,
                   n_experts=8, top_k=2, n_shared_experts=2,
                   d_ff_shared=None, experts_held=4)
    return dataclasses.replace(cfg, **upd)


def shapes_for(cfg: ModelConfig) -> tuple[ShapeSpec, ...]:
    """The shape cells this arch runs (long_500k only for sub-quadratic
    serving memory: recurrent state or a sliding window)."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.supports_long_context():
        out.append(LONG_500K)
    return tuple(out)


SKIPPED_CELLS: dict[tuple[str, str], str] = {
    (a, "long_500k"): "skip:full-attn (quadratic KV at 500k; DESIGN.md §5)"
    for a in ARCHS
    if not get_config(a).supports_long_context()
}
