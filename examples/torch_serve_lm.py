"""Batched LM serving example of the PyTorch port: prefill, then greedy
decode with rolling KV caches, on one NVIDIA GPU (or the CPU).

    PYTHONPATH=src python examples/torch_serve_lm.py --arch mixtral-8x7b --reduced
    PYTHONPATH=src python examples/torch_serve_lm.py --arch rwkv6-3b --device cpu --reduced

The port of ``examples/serve_lm.py``: it runs ``repro_torch.launch.serve``,
whose flags it takes. ``--reduced`` serves the architecture's
``reduce_config`` (MoE routing, sliding-window rolling caches and the
recurrent families included); without it the published width is built,
which for mixtral-8x7b (93 GB of bf16 weights) does not fit one H100.
Weights are random from a fixed seed. Prints prefill and decode
throughput.
"""
from __future__ import annotations

from repro_torch.launch import serve


def main(argv=None) -> dict:
    """Serve one batch; returns what ``launch.serve.main`` returns."""
    return serve.main(argv)


if __name__ == "__main__":
    main()
