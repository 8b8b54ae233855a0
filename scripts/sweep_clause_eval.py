#!/usr/bin/env python3
"""Time launch plans of ``src/repro_torch/csrc/clause_eval.cu`` on one
NVIDIA GPU, at the shapes of the port's main path.

    python3 scripts/sweep_clause_eval.py [--parent DIR] [--out FILE]

Shapes, at the width of the paper's MNIST configuration (m=10, n=2000,
W=49), with chip_smoke.py's served state and requests:
``clause_votes_packed`` at B = 1 and 32 (the serving buckets) and
``clause_outputs_packed`` at (B, m) = (1, 1) (the training round) and
(32, 10). Every plan in ``SMALL_PLANS`` (B <= 2) or ``TILED_PLANS`` is
first held against the plain version bit for bit, then timed by CUDA-graph
replay (``chip_smoke.device_ms``).

``--parent DIR`` names an earlier checkout whose
``src/repro_torch/csrc/clause_votes.cu`` and ``clause_outputs.cu`` (the
kernels before the tiled redesign) are built with the same nvcc flags and
timed in the same call, in turns with the default plan: parent, plan,
plan, parent. ``--out`` writes every row as JSON. Imports no JAX.
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
# keyword overrides of clause_eval.launch_plan, by name: for B <= 2 (the
# direct route by default) and for larger batches (the tiled route)
SMALL_PLANS = {
    "default": {},
    "direct_ks8": dict(ks=8),
    "direct_ks32": dict(ks=32),
    "direct_threads128": dict(threads=128),
    "tiled": dict(route="tiled"),
}
TILED_PLANS = {
    "default": {},
    "threads128": dict(threads=128),
    "threads256": dict(threads=256),
    "blocks264": dict(blocks=264),
    "blocks132": dict(blocks=132),
}


def build_parent(parent: Path) -> dict[str, ctypes.CDLL]:
    """The pre-redesign kernels of ``parent``, built into build/parent-kernels."""
    from repro_torch.kernels import _build
    out_dir = ROOT / "build" / "parent-kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {}
    for name in ("clause_votes", "clause_outputs"):
        src = parent / "src" / "repro_torch" / "csrc" / f"{name}.cu"
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *flags, "-o", str(out_dir / f"{name}.so"),
             str(src)], stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the parent's {name}.cu:\n{err}")
        libs[name] = ctypes.CDLL(str(out_dir / f"{name}.so"))
    p, i = ctypes.c_void_p, ctypes.c_int
    libs["clause_votes"].clause_votes_launch.argtypes = [p, p, p, p, i, i, i, i, p]
    libs["clause_outputs"].clause_outputs_launch.argtypes = [
        p, p, p, ctypes.c_longlong, i, i, p]
    return libs


def parent_votes(libs, inc, lit, pol):
    m, n, w = inc.shape
    out = torch.zeros((lit.shape[0], m), dtype=torch.int32, device=inc.device)
    code = libs["clause_votes"].clause_votes_launch(
        inc.data_ptr(), lit.data_ptr(), pol.data_ptr(), out.data_ptr(), m, n, w,
        lit.shape[0], torch.cuda.current_stream().cuda_stream)
    assert code == 0, code
    return out


def parent_outputs(libs, inc, lit):
    m, n, w = inc.shape
    out = torch.empty((lit.shape[0], m, n), dtype=torch.int8, device=inc.device)
    code = libs["clause_outputs"].clause_outputs_launch(
        inc.data_ptr(), lit.data_ptr(), out.data_ptr(), out.numel(), m * n, w,
        torch.cuda.current_stream().cuda_stream)
    assert code == 0, code
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_clause_eval: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs.tm import PAPER_TM_CONFIGS
    from repro_torch.core.bitpack import packed_literals
    from repro_torch.core.session import TMSession
    from repro_torch.core.types import TMState, clause_polarity
    from repro_torch.kernels import clause_eval

    dev = torch.device("cuda")
    card = chip_smoke.card_line()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    exp = PAPER_TM_CONFIGS["tm_mnist"]
    cfg = exp.tm
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ta, inc = chip_smoke.served_state(cfg, int(exp.avg_clause_len), gen, dev)
    session = TMSession(cfg, engines=("bitpack",), device=dev)
    words = session.prepare(TMState(ta_state=ta)).caches["bitpack"]
    pol = clause_polarity(cfg, dev)
    libs = build_parent(args.parent) if args.parent else None

    cases = []
    for b in (1, 32):
        lw = packed_literals(chip_smoke.requests(inc, b, gen, dev))
        cases.append(("clause_votes_packed", (words, lw, pol),
                      clause_eval.clause_votes_packed, clause_eval.clause_votes_ref,
                      parent_votes))
    for b, m in ((1, 1), (32, cfg.n_classes)):
        ws = words[:m].contiguous()
        lw = packed_literals(chip_smoke.requests(inc[:m], b, gen, dev))
        cases.append(("clause_outputs_packed", (ws, lw),
                      clause_eval.clause_outputs_packed,
                      clause_eval.clause_outputs_ref, parent_outputs))

    rows = []
    for kname, operands, kernel, plain, parent_fn in cases:
        inc_w, lw = operands[0], operands[1]
        m, n, w = inc_w.shape
        b = lw.shape[0]
        want = plain(*operands)
        nbytes = inc_w.numel() * 4 + lw.numel() * 4 + (
            b * m * 4 if kname == "clause_votes_packed" else b * m * n)
        bound_ms, bound_by = chip_smoke.bound(nbytes, b * m * n * w)
        head = f"{kname} (B, m, n, W)=({b}, {m}, {n}, {w})"
        if kname == "clause_votes_packed":   # the caller's zero-fill of out
            fill_ms = chip_smoke.device_ms(
                lambda: torch.zeros((b, m), dtype=torch.int32, device=dev), REPS)
            print(f"{head}: zero-fill of the (B, m) votes (torch.zeros, part "
                  f"of every votes time below) {fill_ms:.5f} ms [{card}]")
        if libs:
            got = parent_fn(libs, *operands)
            torch.cuda.synchronize()
            assert torch.equal(got, want), f"{head}: parent kernel != plain"
        for name, kw in (SMALL_PLANS if b <= 2 else TILED_PLANS).items():
            try:
                plan = clause_eval.launch_plan(b, m, n, w, **kw)
            except ValueError as e:
                print(f"{head} plan {name}: not a plan ({e})")
                continue
            got = kernel(*operands, plan=plan)
            torch.cuda.synchronize()
            assert torch.equal(got, want), f"{head} plan {name}: kernel != plain"
            if libs and name == "default":
                turns = [("parent", lambda: parent_fn(libs, *operands)),
                         ("default", lambda: kernel(*operands, plan=plan))]
                order = [0, 1, 1, 0]
                times = {"parent": [], "default": []}
                for t in order:
                    label, fn = turns[t]
                    times[label].append(chip_smoke.device_ms(fn, REPS))
                ms = sum(times["default"]) / 2
                parent_ms = sum(times["parent"]) / 2
            else:
                ms = chip_smoke.device_ms(lambda: kernel(*operands, plan=plan), REPS)
                parent_ms = None
            row = dict(kernel=kname, shape=[b, m, n, w], plan=name,
                       route=plan.route, sb=plan.sb, threads=plan.threads,
                       tile=[plan.ct, plan.bt], grid=list(plan.grid),
                       smem=plan.smem_bytes, ms=ms, parent_ms=parent_ms,
                       bound_ms=bound_ms, bound_by=bound_by, card=card)
            rows.append(row)
            print(f"{head} plan {name}: equal to plain; "
                  + chip_smoke.plan_line(plan, sms)
                  + f"; device ms {ms:.5f}"
                  + (f" (parent kernel {parent_ms:.5f}, in turns)"
                     if parent_ms is not None else "")
                  + f"; bound {bound_ms:.5f} ({bound_by}), "
                  f"{100 * bound_ms / ms:.1f}% of it [{card}]")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
