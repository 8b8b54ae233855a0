"""LM training CLI (port of ``repro.launch.train``): the data pipeline →
microbatched train step → asynchronous checkpoints → restart, on random
weights.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --steps 50 --batch 8 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-v2-lite \
        --reduced --device cpu

Unlike the reference, which always trains ``reduce_config`` on the CPU, it
builds the published config at full width unless ``--reduced`` is given
(the reference's ``--full`` is accepted and is the default), and runs on
the card unless ``--device cpu`` is given. As in the reference, weights are
drawn in float32 from seed 0, batches come from ``TokenBatcher(seed=0)``,
a checkpoint is written every 10 steps (two kept) and at the end, a run
resumes from the newest checkpoint in ``--ckpt-dir``, and vlm / encdec
configs are refused: the CLI drives token-only batches. A checkpoint holds
the float32 masters, both moments and the error-feedback residuals: about
27.5 GB for qwen3-1.7b at full width. ``main(argv)`` prints the
reference's lines and returns the numbers as a dict (the final train state
under ``state``).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import ARCHS, PORT_ARCHS, get_config, reduce_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.types import resolve_device
from repro_torch.data.pipeline import TokenBatcher
from repro_torch.models.model import build
from repro_torch.runtime.trainer import Trainer, TrainLoopConfig
from repro_torch.steps import (
    init_train_state,
    make_step,
    train_state_from_ckpt,
    train_state_to_ckpt,
)

SEED = 0


def main(argv=None) -> dict:
    """Parse ``argv``, train, print the reference's lines and return the
    numbers (``metrics_log``, ``end_step``, ``tok_s``, ``state``, …)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b",
                    help="one of: " + ", ".join(ARCHS + PORT_ARCHS))
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--reduced", action="store_true",
                    help="train reduce_config(arch) instead of the full width")
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--compress", default="none",
                    choices=["none", "bf16", "int8"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    if cfg.family in ("vlm", "encdec"):
        raise SystemExit(
            "train CLI drives token-only batches; use examples/ for "
            "multimodal training loops")
    shape = ShapeSpec("cli", "train", args.seq, args.batch)
    step = make_step(cfg, shape, None, microbatches=args.microbatches,
                     compress=args.compress)
    params = build(cfg).init(torch.Generator(device=dev).manual_seed(SEED))
    batcher = TokenBatcher(cfg.vocab, args.batch, args.seq, seed=SEED)

    def batch_fn(i):
        return {k: torch.from_numpy(v).to(dev) for k, v in batcher(i).items()}

    trainer = Trainer(
        step_fn=step.fn, state=init_train_state(params), batcher=batch_fn,
        checkpointer=Checkpointer(args.ckpt_dir, keep=2),
        loop=TrainLoopConfig(total_steps=args.steps, ckpt_every=10,
                             log_every=5),
        to_ckpt=train_state_to_ckpt, from_ckpt=train_state_from_ckpt)
    t0 = time.time()
    end = trainer.run()
    dt = time.time() - t0
    for s, m in trainer.metrics_log:
        print(f"step {s:5d}  loss {m['loss']:.4f}  nll {m['nll']:.4f}  "
              f"gnorm {m['grad_norm']:.3f}")
    toks = args.steps * args.batch * args.seq
    print(f"\ntrained to step {end}: {toks/dt:.0f} tok/s wall "
          f"({dt:.1f}s total)")
    return {"arch": cfg.name, "reduced": args.reduced, "device": str(dev),
            "end_step": end, "metrics_log": trainer.metrics_log,
            "tok_s": toks / dt, "seconds": dt, "state": trainer.state}


if __name__ == "__main__":
    main()
