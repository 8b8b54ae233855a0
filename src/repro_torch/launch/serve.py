"""LM serving CLI (port of ``repro.launch.serve``): batched prefill into a
KV cache, then a greedy decode loop, on random weights.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --batch 4 --prompt-len 128 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-lite \
        --device cpu --reduced

Unlike the reference, which always serves ``reduce_config`` on the CPU, it
builds the published config at full width unless ``--reduced`` is given,
and runs on the card unless ``--device cpu`` is given. As in the reference,
weights are drawn in float32 from seed 0 and cast to bf16, prompts come
from ``numpy.random.default_rng(0)``, ``--temperature`` is parsed and not
used (decoding is greedy), and vlm / encdec configs are refused: the CLI
drives token-only prompts. ``main(argv)`` prints the reference's lines and
returns the numbers as a dict.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, PORT_ARCHS, get_config, reduce_config
from repro_torch.core.types import resolve_device
from repro_torch.models.model import build

SEED = 0


def make_prompts(cfg, batch: int, prompt_len: int, device) -> torch.Tensor:
    """The reference CLI's prompts: ``default_rng(0)`` token ids."""
    rng = np.random.default_rng(SEED)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (batch, prompt_len))).to(
        device=device, dtype=torch.int32)


def init_bf16(model, device):
    """The model's float32 init from a generator seeded with ``SEED`` on
    ``device``, cast to bf16 (the reference casts every float32 leaf)."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    return model.init(gen).to(torch.bfloat16)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    """Parse ``argv``, serve one batch, print the reference's lines and
    return the numbers (``generations`` as a (batch, gen) array)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b",
                    help="one of: " + ", ".join(ARCHS + PORT_ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--reduced", action="store_true",
                    help="serve reduce_config(arch) instead of the full width")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    if cfg.family in ("vlm", "encdec"):
        raise SystemExit("serve CLI drives token-only prompts")
    model = build(cfg)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = init_bf16(model, dev)
    param_bytes = sum(p.numel() * p.element_size() for p in params.parameters())

    prompts = make_prompts(cfg, args.batch, args.prompt_len, dev)
    cache_len = args.prompt_len + args.gen

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, cache_len, tokens=prompts)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    tok = logits.argmax(-1)[:, None].to(torch.int32)
    out = [tok]
    t0 = time.perf_counter()
    for i in range(args.gen - 1):
        pos = torch.full((args.batch,), args.prompt_len + i, dtype=torch.int32,
                         device=dev)
        logits, cache = model.decode_step(params, tok, cache, pos)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    gen = torch.cat(out, dim=1).cpu().numpy()
    steps = max(args.gen - 1, 1)
    res = {
        "arch": cfg.name, "reduced": args.reduced, "device": str(dev),
        "batch": args.batch, "prompt_len": args.prompt_len, "gen": args.gen,
        "param_count": sum(p.numel() for p in params.parameters()),
        "param_bytes": param_bytes,
        "prefill_ms": t_prefill * 1e3,
        "prefill_tok_s": args.batch * args.prompt_len / t_prefill,
        "decode_ms_per_step": t_decode * 1e3 / steps,
        "decode_tok_s": args.batch * (args.gen - 1) / max(t_decode, 1e-9),
        "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else None),
        "generations": gen,
    }
    width = "(reduced)" if args.reduced else "(full width)"
    print(f"arch={cfg.name} {width} batch={args.batch} device={dev}")
    print(f"prefill: {res['prefill_tok_s']:.0f} tok/s "
          f"({res['prefill_ms']:.0f} ms)")
    print(f"decode:  {res['decode_tok_s']:.0f} tok/s "
          f"({res['decode_ms_per_step']:.1f} ms/step)")
    print("sample generations (token ids):")
    for b in range(min(2, args.batch)):
        print(f"  [{b}] {gen[b][:12].tolist()}")
    return res


if __name__ == "__main__":
    main()
