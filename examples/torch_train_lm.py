"""LM training example of the PyTorch port: a ~20M-parameter qwen3-family
model on one NVIDIA GPU (or the CPU).

    PYTHONPATH=src python examples/torch_train_lm.py --steps 200
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 40

The port of ``examples/train_lm.py``: the data pipeline → microbatched
train step (bf16 compute, float32 masters) → cosine schedule → asynchronous
checkpoints every 100 steps, on a Zipf + n-gram synthetic stream whose NLL
goes down. Weights are random from a fixed seed.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.types import resolve_device
from repro_torch.data.pipeline import TokenBatcher
from repro_torch.models.model import build
from repro_torch.steps import init_train_state, make_step, train_state_to_ckpt


def main(argv=None) -> dict:
    """Train; print the reference's lines and return the first and last NLL
    and the throughput."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # ~20M params: qwen3 geometry, 4 layers × d512
    cfg = dataclasses.replace(
        get_config("qwen3-1.7b"), n_layers=4, d_model=512, n_heads=8,
        n_kv_heads=4, head_dim=64, d_ff=1536, vocab=8192, remat=False,
        tie_embeddings=True)
    print(f"params ≈ {cfg.param_count()/1e6:.1f}M")

    shape = ShapeSpec("example", "train", args.seq, args.batch)
    step = make_step(cfg, shape, None, microbatches=2, peak_lr=1e-3,
                     warmup_steps=20, total_steps=args.steps)
    params = build(cfg).init(torch.Generator(device=dev).manual_seed(0))
    state = init_train_state(params)
    batcher = TokenBatcher(cfg.vocab, args.batch, args.seq, seed=3)
    ckpt = Checkpointer(args.ckpt_dir, keep=2)

    t0 = time.time()
    first = last = None
    tps = 0.0
    for i in range(args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batcher(i).items()}
        state, metrics = step.fn(state, batch)
        if i == 0:
            first = float(metrics["nll"])
        if i % 20 == 0 or i == args.steps - 1:
            last = float(metrics["nll"])
            tps = args.batch * args.seq * (i + 1) / (time.time() - t0)
            print(f"step {i:4d}  nll {last:.4f}  lr {float(metrics['lr']):.2e}"
                  f"  {tps:.0f} tok/s")
        if (i + 1) % 100 == 0:
            ckpt.save(i + 1, train_state_to_ckpt(state))
    ckpt.wait()
    print(f"\nnll {first:.3f} → {last:.3f} "
          f"({'improved ✓' if last < first else 'NOT improved ✗'})")
    return {"first_nll": first, "last_nll": last, "tok_s": tps,
            "param_count": sum(p.numel() for p in params.parameters())}


if __name__ == "__main__":
    main()
