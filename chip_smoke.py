#!/usr/bin/env python3
"""Chip smoke for the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, each of which must pass (the script exits non-zero at the first
failure, and at once when no CUDA device is present):

1. **Build** every CUDA kernel under ``src/repro_torch/csrc`` with ``nvcc``
   for ``sm_90a`` (one process per source, in parallel) into ``build/``.
2. **Kernels vs plain**, on the card, at the width of the paper's MNIST
   configuration (``tm_mnist``: m=10 classes, n=2000 clauses, o=784
   features). The served state has about 58 literals per clause (the
   paper's MNIST clause length) and no clause includes both x_k and ¬x_k.
   Each request satisfies one randomly chosen clause and is random
   elsewhere, so the scores are not all equal. For B ∈ {1, 32} each kernel
   must equal its plain PyTorch version bit for bit (tolerance 0) and the
   dense engine's scores. Device times come from CUDA graphs replayed
   between CUDA events (no host launch work in them): kernel, plain version,
   and one PyTorch call as yardstick (the float32 ``torch.matmul`` that the
   dense / XLA form of the same votes is built on). ``call_ms`` is the
   kernel's time per call from Python, wrapper included.
3. **Serve** the same state through ``TMSession`` + ``AsyncTMServer``
   (``max_batch=32``, 2 tenants), first with ``engine="indexed"``, then
   ``engine="bitpack"``. Every result must be a ``ScoreResult`` equal to the
   dense engine's scores on the card; the bucket cache must not miss or
   prepare anything new; and each engine's kernel must have launched at
   least once per served batch. Launch counts are set to 0 just before each
   serve and read just after.
4. Print ``{"kernels": [...]}``, the card's name and power limit as
   ``nvidia-smi`` reports them, and, last, the ``{"ok": true, ...}`` line.

Imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
BATCHES = (1, 32)
N_REQUESTS = 1024
# Peak rates of one H100 SXM. Memory: 3.35 TB/s (NVIDIA data sheet). The
# votes are 32-bit compare and logic instructions, not FLOPs: the CUDA C++
# Programming Guide's arithmetic-throughput table gives compute capability
# 9.0 64 such results per clock per SM, half its 128 float32 FMAs, and the
# data sheet's 67 TFLOP/s float32 counts each FMA as two FLOPs, so the
# logic rate is 67e12 / 4 (132 SMs x 64 x 1.98 GHz).
PEAK_BYTES_PER_S = 3.35e12
PEAK_LOGIC_OPS_PER_S = 67e12 / 4


def require(cond, msg: str) -> None:
    """Fail the run (an exception, so the exit code is non-zero)."""
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    """``name, power.limit`` exactly as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, reps: int) -> float:
    """Time per call of ``fn`` over ``reps`` back-to-back calls, between
    CUDA events: what a caller pays, host-side launch work included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Device time per call of ``fn``: ``reps`` calls captured in one CUDA
    graph and replayed between CUDA events, so no host launch work is in
    the reading."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _wall_ms(fn, sync: bool = False) -> float:
    """Host wall time of one call of ``fn`` (ms); ``sync`` waits for the
    device afterwards, outside the reading."""
    t0 = time.perf_counter()
    fn()
    ms = (time.perf_counter() - t0) * 1e3
    if sync:
        torch.cuda.synchronize()
    return ms


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    """Least time (ms) for the work and what sets it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_LOGIC_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def served_state(cfg, avg_len: int, gen, dev):
    """TA state whose clauses include about ``avg_len`` literals each (the
    lengths are uniform on [avg_len/2, 3·avg_len/2]), never x_k with ¬x_k."""
    m, n, o = cfg.n_classes, cfg.n_clauses, cfg.n_features
    lengths = torch.randint(avg_len // 2, avg_len + avg_len // 2 + 1,
                            (m, n, 1), generator=gen, device=dev)
    rank = torch.rand((m, n, o), generator=gen, device=dev).argsort(-1).argsort(-1)
    chosen = rank < lengths
    negated = torch.rand((m, n, o), generator=gen, device=dev) < 0.5
    inc = torch.cat([chosen & ~negated, chosen & negated], dim=-1)
    ta = torch.where(inc, cfg.n_states + 1, cfg.n_states).to(cfg.state_dtype)
    return ta, inc


def requests(inc, count: int, gen, dev) -> torch.Tensor:
    """(count, o) uint8 rows, each satisfying one random (class, clause)."""
    m, n, two_o = inc.shape
    o = two_o // 2
    x = torch.randint(0, 2, (count, o), generator=gen, device=dev,
                      dtype=torch.uint8)
    ci = torch.randint(0, m, (count,), generator=gen, device=dev)
    cj = torch.randint(0, n, (count,), generator=gen, device=dev)
    rows = inc[ci, cj]
    x = torch.where(rows[:, :o], 1, x)
    return torch.where(rows[:, o:], 0, x).to(torch.uint8)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs.tm import PAPER_TM_CONFIGS
    from repro_torch.core import tm
    from repro_torch.core.bitpack import packed_literals, unpack_bits
    from repro_torch.core.session import TMSession
    from repro_torch.core.types import TMState, clause_polarity, literals_from_input
    from repro_torch.kernels import _build, clause_eval, indexed
    from repro_torch.serving import AsyncTMServer, ScoreResult

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)

    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {sorted(libs)} with nvcc (one process per source, in "
          f"parallel) in {build_s:.2f} s")
    print(f"card: {card}")

    # -- 2. kernels vs plain at the tm_mnist width ----------------------------
    exp = PAPER_TM_CONFIGS["tm_mnist"]
    cfg = exp.tm
    m, n, L = cfg.n_classes, cfg.n_clauses, cfg.n_literals
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ta, inc = served_state(cfg, int(exp.avg_clause_len), gen, dev)
    state = TMState(ta_state=ta)
    session = TMSession(cfg, engines=("indexed", "bitpack", "dense"), device=dev)
    bundle = session.prepare(state)
    pos, words = bundle.index.pos, bundle.caches["bitpack"]
    pol = clause_polarity(cfg, dev)
    print(f"state: m={m} n={n} 2o={L}, mean clause length "
          f"{float(inc.sum(-1).float().mean()):.2f} literals; pos "
          f"{pos.numel() * 4 / 1e6:.1f} MB, include words "
          f"{words.numel() * 4 / 1e6:.2f} MB")

    member_f32 = (pos != -1).reshape(m * n, L).to(torch.float32)
    inc_f32 = unpack_bits(words, L).reshape(m * n, L).to(torch.float32)
    rows = {}
    for b in BATCHES:
        x = requests(inc, b, gen, dev)
        lit, lw = literals_from_input(x), packed_literals(x)
        dense = tm.scores(cfg, state, x)
        cases = {
            "indexed_votes": (indexed.indexed_votes, indexed.indexed_votes_ref,
                              (pos, lit, pol), member_f32),
            "clause_votes_packed": (clause_eval.clause_votes_packed,
                                    clause_eval.clause_votes_ref,
                                    (words, lw, pol), inc_f32),
        }
        false_f32 = (lit == 0).to(torch.float32)
        for kname, (kernel, plain, args, mask_f32) in cases.items():
            got, want = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            err = int((got - want).abs().max())
            require(torch.equal(got, want),
                    f"{kname} B={b}: kernel != plain (max |diff| {err})")
            require(torch.equal(got, dense),
                    f"{kname} B={b}: kernel != dense engine scores")
            require(want.unique().numel() > 1,
                    f"{kname} B={b}: scores are all equal; the check is void")
            ms = device_ms(lambda: kernel(*args), 50)
            plain_ms = device_ms(lambda: plain(*args), 10)
            yard_ms = device_ms(lambda: torch.matmul(false_f32, mask_f32.T), 20)
            wrapper_ms = call_ms(lambda: kernel(*args), 50)
            nbytes = sum(a.numel() * a.element_size() for a in args) + b * m * 4
            # The function's own work, not this kernel's (its shuffles are
            # one way of sharing a word among lanes, and not the work):
            if kname == "indexed_votes":   # a compare and an OR per membership
                ops = 2 * m * n * L * math.ceil(b / 32)   # test, 32 samples each
            else:                          # one and-not-or (LOP3) per include
                ops = m * n * words.shape[-1] * b         # word per sample
            bound_ms, bound_by = bound(nbytes, ops)
            rows[(kname, b)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                    yardstick_ms=yard_ms, bound_ms=bound_ms,
                                    bound_by=bound_by, call_ms=wrapper_ms)
            print(f"{kname} B={b}: equal to plain and dense (max |diff| {err}); "
                  f"device ms: kernel {ms:.4f}, plain {plain_ms:.4f}, matmul "
                  f"yardstick {yard_ms:.4f}, bound {bound_ms:.4f} ({bound_by}); "
                  f"kernel per call from Python {wrapper_ms:.4f} ms [{card}]")

    # -- 3. serve through the entry points ------------------------------------
    xs = requests(inc, N_REQUESTS, gen, dev)
    dense_rows = session.scores(bundle, xs, engine="dense").cpu().numpy()
    xs_host = xs.cpu().numpy()
    launches = {}
    counters = {"indexed": indexed.indexed_votes,
                "bitpack": clause_eval.clause_votes_packed}
    for engine, counter in counters.items():
        server = AsyncTMServer(session, bundle, engine=engine, max_batch=32)
        warm = server.aot.counters()
        indexed.indexed_votes.launches = 0
        clause_eval.clause_votes_packed.launches = 0
        server.start()
        try:
            t0 = time.perf_counter()
            promises = [server.submit(row, tenant=f"tenant{i % 2}")
                        for i, row in enumerate(xs_host)]
            submit_s = time.perf_counter() - t0
            results = [p.wait(120) for p in promises]
            wall = time.perf_counter() - t0
        finally:
            server.stop()
        launched = counter.launches
        launches[engine] = launched
        stats = server.stats()
        require(all(isinstance(r, ScoreResult) for r in results),
                f"{engine}: a request was not served: "
                f"{[r for r in results if not isinstance(r, ScoreResult)][:1]}")
        served = np.stack([r.scores for r in results])
        require(np.array_equal(served, dense_rows),
                f"{engine}: served scores differ from the dense engine's")
        aot = server.aot.counters()
        require(aot["misses"] == 0, f"{engine}: bucket cache missed: {aot}")
        require(aot["lowerings"] == warm["lowerings"],
                f"{engine}: bucket entries prepared while serving: {aot}")
        require(launched >= stats["batches"] > 0,
                f"{engine}: kernel launched {launched} times for "
                f"{stats['batches']} batches")
        lat = np.asarray([r.latency_s for r in results]) * 1e3
        p50, p99 = np.percentile(lat, [50, 99])
        print(f"serve[{engine}]: {len(results)} requests from 2 tenants in "
              f"{stats['batches']} batches (mean {stats['rows_real'] / stats['batches']:.1f} "
              f"rows), {launched} kernel launches, latency p50 {p50:.3f} ms "
              f"p99 {p99:.3f} ms, {len(results) / wall:.1f} rows/s (submitting "
              f"took {submit_s * 1e3:.1f} of {wall * 1e3:.1f} ms), all equal to "
              f"dense [{card}]")

        # one full bucket, three ways: the device work of the engine's scores
        # (graph replay), a dispatch through the bucket cache from a host
        # array (returns before the device finishes), and the round trip to
        # host scores — device busy share = device / round trip
        top = server.sizes[-1]
        fn = session.lower_scores(bundle, top, engine=engine)
        xb_dev, xb_host = xs[:top].contiguous(), xs_host[:top]
        busy_ms = device_ms(lambda: fn(xb_dev), 20)
        disp_ms = np.median([_wall_ms(lambda: server.aot(
            xb_host, engine=engine, bucket=top), sync=True) for _ in range(50)])
        trip_ms = np.median([_wall_ms(lambda: server.aot(
            xb_host, engine=engine, bucket=top).cpu()) for _ in range(50)])
        print(f"batch[{engine}] B={top}: device {busy_ms:.4f} ms, dispatch "
              f"{disp_ms:.4f} ms, round trip {trip_ms:.4f} ms (medians of 50), "
              f"device busy {100 * busy_ms / trip_ms:.1f}% of the round trip "
              f"[{card}]")

    # -- 4. report ----------------------------------------------------------
    top = BATCHES[-1]
    kernels = []
    for kname, engine, src, replaces in (
            ("indexed_votes", "indexed", "src/repro_torch/csrc/indexed_votes.cu",
             "src/repro/kernels/indexed.py:103"),
            ("clause_votes_packed", "bitpack", "src/repro_torch/csrc/clause_votes.cu",
             "src/repro/kernels/clause_eval.py:45")):
        r = rows[(kname, top)]
        kernels.append({"name": kname, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[engine],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        # no single PyTorch call computes these votes; the
                        # float32 matmul they are built on is the yardstick
                        "library_ms": None, "yardstick_ms": r["yardstick_ms"],
                        "call_ms": r["call_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
