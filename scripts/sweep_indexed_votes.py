#!/usr/bin/env python3
"""Time the list-walk kernel ``src/repro_torch/csrc/indexed_votes.cu`` on
one NVIDIA GPU at the shapes of the port's main path, over cluster sizes.

    python3 scripts/sweep_indexed_votes.py [--parent DIR] [--out FILE]

Shapes: the paper's MNIST width (``tm_mnist``: m=10, n=2000, 2o=1568) and
IMDb width (``tm_imdb``: m=2, n=2000, 2o=10000) with chip_smoke.py's served
states and requests, at B = 1 and 32 (the serving buckets). For each,
clusters of ``CLUSTERS`` blocks are held against the plain walk bit for bit
and timed by CUDA-graph replay (``chip_smoke.device_ms``), beside the walk's
bound (``chip_smoke.walk_work``: its bytes over 3.35 TB/s).

``--parent DIR`` names an earlier checkout whose
``src/repro_torch/csrc/indexed_votes.cu`` is the kernel that streams the
position matrix (``indexed_votes_launch(pos, lit, pol, fl, out, m, n, L,
B, vec4, stream)``); it is built with the same nvcc flags, held
against the same votes, and timed in the same call in turns with the
default plan (``walk_plan``'s cluster): parent, walk, walk, parent.
``--out`` writes every row as JSON (default
``results/torch/sweep_indexed_votes.json``). Imports no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke  # noqa: E402

SEED = 0
REPS = 100
CLUSTERS = (1, 2, 4, 8, 16)


def build_parent(parent: Path):
    """The parent's pos-streaming launcher, built into build/parent-kernels."""
    from repro_torch.kernels import _build
    out_dir = ROOT / "build" / "parent-kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "indexed_votes.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(parent / "src/repro_torch/csrc/indexed_votes.cu")],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).indexed_votes_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def parent_votes(fn, pos, lit, pol):
    """The parent kernel's votes (its wrapper, without its checks)."""
    m, n, L = pos.shape
    b = lit.shape[0]
    out = torch.zeros((b, m), dtype=torch.int32, device=pos.device)
    fl = torch.empty(((b + 31) // 32, L), dtype=torch.int32, device=pos.device)
    vec4 = int(L % 4 == 0 and pos.data_ptr() % 16 == 0)
    code = fn(pos.data_ptr(), lit.data_ptr(), pol.data_ptr(), fl.data_ptr(),
              out.data_ptr(), m, n, L, b, vec4,
              torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"parent indexed_votes: CUDA error {code}")
    return out


def cases(dev):
    """(name, cfg, index, lit, pol) at both widths and both buckets."""
    from repro_torch.configs.tm import PAPER_TM_CONFIGS
    from repro_torch.core.types import clause_polarity, literals_from_input
    from repro_torch.data.synthetic import bow_documents

    gen = torch.Generator(device=dev).manual_seed(SEED)
    for width in ("tm_mnist", "tm_imdb"):
        exp = PAPER_TM_CONFIGS[width]
        cfg = exp.tm
        _, inc = chip_smoke.served_state(cfg, int(exp.avg_clause_len), gen, dev)
        index = chip_smoke.index_from_include(cfg, inc, cfg.n_clauses)
        base = None
        if width == "tm_imdb":
            base, _ = bow_documents(32, cfg.n_features, cfg.n_classes, seed=SEED)
        x = chip_smoke.requests(inc, 32, gen, dev, base=base)
        pol = clause_polarity(cfg, dev)
        for b in (1, 32):
            lit = literals_from_input(x[:b].contiguous())
            yield f"{width} B={b}", cfg, index, lit, pol


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "results" / "torch" / "sweep_indexed_votes.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_indexed_votes: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import indexed

    dev = torch.device("cuda")
    card = chip_smoke.card_line()
    parent = build_parent(args.parent) if args.parent else None
    rows = []
    for name, cfg, index, lit, pol in cases(dev):
        want = indexed.indexed_votes_walk_ref(*index, lit, pol)
        bound_ms, by = chip_smoke.bound(*chip_smoke.walk_work(index, lit))
        row = {"case": name, "card": card, "bound_ms": bound_ms, "bound_by": by,
               "default_cluster": indexed.walk_plan(
                   lit.shape[0], cfg.n_classes, cfg.n_clauses).cluster}
        for cluster in CLUSTERS:
            got = indexed.indexed_votes(*index, lit, pol, cluster=cluster)
            if not torch.equal(got, want):
                raise RuntimeError(f"{name} cluster {cluster}: kernel != walk")
            row[f"cluster{cluster}_ms"] = chip_smoke.device_ms(
                lambda: indexed.indexed_votes(*index, lit, pol, cluster=cluster),
                REPS)
        if parent is not None:
            if not torch.equal(parent_votes(parent, index.pos, lit, pol), want):
                raise RuntimeError(f"{name}: the parent kernel != walk")
            turns = []
            for who in ("parent", "walk", "walk", "parent"):
                fn = ((lambda: parent_votes(parent, index.pos, lit, pol))
                      if who == "parent" else
                      (lambda: indexed.indexed_votes(*index, lit, pol)))
                turns.append((who, chip_smoke.device_ms(fn, REPS)))
            row["turns"] = turns
        rows.append(row)
        print(json.dumps(row))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(rows, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
