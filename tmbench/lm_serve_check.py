"""The LM family's serving check; not part of a benchmark run:

    python3 -m tmbench.lm_serve_check --config deepseek_v2_lite_ep8 \\
        --seed 1 [--batch 2 --prompt 4096 --gen 64] [--out serve.jsonl]

builds the configuration's model on random weights from the seed, lets the
plain float32 reference (``tmbench/reference/deepseek_v2.py``) run its full
forward over the prompt and the continuation (dropless), then serves the
same ids with the program's own steps in bf16: ``steps.make_prefill_step``
over the prompt into a cache of ``prompt + gen`` positions, and ``gen``
steps of ``steps.make_decode_step``, each fed the next id. It prints the
logits' ``max|Δ| / max|ref|`` over the prefill's last position and every
decode step, the same of the reference in the control's precision
(``control_err``: its activations rounded through float8), the cache's
tensors per layer, and the peak memory.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def check(conf: dict, seed: int, batch: int, prompt: int, gen: int,
          device) -> dict:
    """Run the check (see the module docstring); returns its numbers."""
    import torch

    from repro_torch import steps
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import transformer

    from tmbench import gen as G
    from tmbench import harness
    from tmbench.reference import deepseek_v2 as ref

    family = harness.family_module(harness.family_of(conf))
    cfg = family.config(conf)
    total = prompt + gen
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    params = transformer.init_params(G.generator(seed, "weights", device), cfg)
    ids = torch.randint(0, cfg.vocab, (batch, total),
                        generator=G.generator(seed, "serve", device), device=device)
    t0 = time.perf_counter()
    with torch.no_grad():
        weights = family.reference_weights(params)
        want, _ = ref.forward(weights, ids, conf, (0, cfg.n_held), train=False)
        want = want[:, prompt - 1:total - 1].clone()
        low, _ = ref.forward(weights, ids, conf, (0, cfg.n_held), train=False,
                             low=True)
        low = low[:, prompt - 1:total - 1].clone()
        del weights
    ref_s = time.perf_counter() - t0
    params = params.to(torch.bfloat16)
    prefill = steps.make_step(cfg, ShapeSpec("serve", "prefill", total, batch)).fn
    decode = steps.make_step(cfg, ShapeSpec("serve", "decode", total, batch)).fn
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = prefill(params, {"tokens": ids[:, :prompt].to(torch.int32)})
        got = [logits]
        for i in range(gen - 1):
            pos = torch.full((batch,), prompt + i, dtype=torch.int32, device=device)
            logits, cache = decode(params, cache,
                                   ids[:, prompt + i:prompt + i + 1].to(torch.int32), pos)
            got.append(logits)
    got = torch.stack(got, 1).float()
    serve_s = time.perf_counter() - t0
    err = (got - want).abs().amax((0, 2)) / want.abs().max()
    shapes = {key: {n: list(t.shape) for n, t in block.items()}
              for key, block in cache["layers"].items()}
    shapes.update({f"head.{i}": {n: list(t.shape) for n, t in block.items()}
                   for i, block in enumerate(cache.get("head", []))})
    return {"config": conf["name"], "seed": seed, "batch": batch,
            "prompt": prompt, "gen": gen,
            "logits_err": float(err.max()),
            "logits_err_prefill": float(err[0]),
            "logits_err_by_step": [float(e) for e in err],
            "control_err": float((low - want).abs().max() / want.abs().max()),
            "cache": shapes,
            "cache_bytes_per_token_layer": sum(
                t.element_size() * t.shape[-1] for n, t in
                next(iter(cache["layers"].values())).items() if n != "pos"),
            "reference_s": ref_s, "serve_s": serve_s,
            "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(device))
                                  if device.type == "cuda" else 0)}


def main(argv=None) -> int:
    """See the module docstring."""
    parser = argparse.ArgumentParser(prog="python3 -m tmbench.lm_serve_check")
    parser.add_argument("--config", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--prompt", type=int, default=4096)
    parser.add_argument("--gen", type=int, default=64)
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from tmbench import harness

    torch.backends.cuda.matmul.allow_tf32 = False
    conf = harness.load_json(ROOT / "tmbench" / "configs" / f"{args.config}.json")
    print(f"card: {harness.card_line()}", file=sys.stderr)
    row = check(conf, args.seed, args.batch, args.prompt, args.gen,
                torch.device(args.device))
    text = json.dumps(row)
    print(text, flush=True)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        with out.open("a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
