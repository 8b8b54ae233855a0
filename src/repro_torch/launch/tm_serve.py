"""TM serving CLI (port of ``repro.launch.tm_serve``: ``run`` / ``serve_engine``
and the ``--smoke`` entry).

    PYTHONPATH=src python -m repro_torch.launch.tm_serve --smoke
    PYTHONPATH=src python -m repro_torch.launch.tm_serve --engine indexed,bitpack
    PYTHONPATH=src python -m repro_torch.launch.tm_serve --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.tm_serve --smoke \
        --clause-shards 2 --data-shards 2 --devices cuda:0,cuda:0,cuda:0,cuda:0

Each engine serves a synthetic closed-loop load: a simulated arrival clock
advanced by *measured* batch times (deterministic per seed, no sleeps). Its
percentiles are clean per-batch latency under that load; its throughput
splices compute windows end to end and is not a wall-clock rate. The record
is written to ``BENCH_tm_serve_torch.json`` (git-ignored). The open-loop
``sustained_load`` comparison and ``serving/loadgen.py`` come in a later
slice. Runs on the card unless ``--device cpu`` is given.

``--clause-shards`` / ``--data-shards`` serve through a sharded session
(``core/distributed.py``); the ranks take ``cuda:0 … cuda:k-1`` (or
``--device cpu``), or the explicit ``--devices`` list, which may repeat a
device. Unlike the reference, ``--data-shards`` defaults to 1 rather than
to every spare device: the placement is always the one asked for. The
record's ``topology`` is ``session.describe()``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.core.engines import registered_engines
from repro_torch.core.session import TMSession, Topology
from repro_torch.core.types import TMConfig, TMState, resolve_device
from repro_torch.data.synthetic import binarized_images
from repro_torch.launch.mesh import DeviceMesh, make_mesh
from repro_torch.serving.aot import bucket_for, buckets


@dataclasses.dataclass(frozen=True)
class ServePolicy:
    """Batching policy of the closed-loop serve."""

    max_batch: int = 32
    max_wait_ms: float = 2.0  # batching window when the queue is empty


def _random_state(cfg: TMConfig, rng: np.random.Generator,
                  include_density: float) -> TMState:
    """Random sparse include state (CPU) — serving measures evaluation, not
    training quality."""
    inc = rng.uniform(size=(cfg.n_classes, cfg.n_clauses,
                            cfg.n_literals)) < include_density
    return TMState(ta_state=torch.from_numpy(
        np.where(inc, cfg.n_states + 1, cfg.n_states).astype(np.int16)))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_engine(session: TMSession, bundle, x_all: np.ndarray,
                 arrivals: np.ndarray, *, engine: str,
                 policy: ServePolicy) -> dict:
    """Run the closed-loop batched loop for one engine (see the module
    docstring for what its numbers mean)."""
    sizes = buckets(policy.max_batch, min_batch=session.topology.data_shards)
    o = x_all.shape[1]
    dev = session.device

    warm_s = {}
    for b in sizes:  # first call per bucket outside the timed loop
        t0 = time.perf_counter()
        session.scores(bundle, np.zeros((b, o), np.uint8), engine=engine)
        _sync(dev)
        warm_s[str(b)] = round(time.perf_counter() - t0, 4)

    n = x_all.shape[0]
    wait = policy.max_wait_ms / 1e3
    clock = float(arrivals[0])
    i = 0
    lat: list[float] = []
    rows_real = rows_padded = n_batches = 0
    cap = sizes[-1]
    while i < n:
        if arrivals[i] > clock:               # idle: admit next + hold window
            clock = float(arrivals[i]) + wait
        k = int(np.searchsorted(arrivals[i:i + cap], clock, side="right"))
        k = max(k, 1)
        b = bucket_for(k, sizes)
        xp = np.zeros((b, o), np.uint8)
        xp[:k] = x_all[i:i + k]
        t0 = time.perf_counter()
        session.scores(bundle, xp, engine=engine).cpu()
        done = clock + (time.perf_counter() - t0)
        lat.extend(done - arrivals[i:i + k])
        rows_real += k
        rows_padded += b
        n_batches += 1
        clock = done
        i += k

    lat_ms = np.asarray(lat) * 1e3
    p50, p90, p95, p99 = np.percentile(lat_ms, [50, 90, 95, 99])
    throughput = n / (clock - float(arrivals[0]))
    offered = n / (float(arrivals[-1]) - float(arrivals[0]) + 1e-12)
    return {
        "engine": engine,
        # the queue grew for the whole run: percentiles measure backlog
        "saturated": bool(throughput < 0.95 * offered),
        "requests": n,
        "batches": n_batches,
        "mean_batch": round(rows_real / n_batches, 2),
        "padding_efficiency": round(rows_real / rows_padded, 4),
        "latency_ms": {"p50": float(p50), "p90": float(p90),
                       "p95": float(p95), "p99": float(p99),
                       "mean": float(lat_ms.mean()),
                       "max": float(lat_ms.max())},
        "throughput_rps": throughput,
        "warm_s_per_bucket": warm_s,
    }


def device_record(device: torch.device) -> dict:
    """What the numbers ran on: platform, card name, count."""
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": torch.cuda.device_count()}
    return {"platform": "cpu", "kind": "cpu", "count": 1}


def run(cfg: TMConfig, *, engines=("indexed",), topology: Topology | None = None,
        mesh: DeviceMesh | None = None, n_requests: int = 512,
        rps: float = 2000.0, policy: ServePolicy = ServePolicy(),
        seed: int = 0, include_density: float = 0.08, device="cuda") -> dict:
    """Serve a synthetic load through each engine on one session (sharded
    when ``topology`` or ``mesh`` spans several ranks)."""
    rng = np.random.default_rng(seed)
    session = TMSession(cfg, topology, mesh=mesh, engines=engines,
                        device=device)
    bundle = session.prepare(_random_state(cfg, rng, include_density))

    x_all, _ = binarized_images(n_requests, cfg.n_features, cfg.n_classes,
                                seed=seed + 1)
    arrivals = np.cumsum(rng.exponential(1.0 / rps, n_requests))

    record = {
        "config": {"n_classes": cfg.n_classes, "n_clauses": cfg.n_clauses,
                   "n_features": cfg.n_features},
        "load": {"requests": n_requests, "rps": rps},
        "policy": {"max_batch": policy.max_batch,
                   "max_wait_ms": policy.max_wait_ms},
        "device": device_record(session.device),
        "topology": session.describe(),
        "engines": {},
    }
    for engine in engines:
        record["engines"][engine] = serve_engine(
            session, bundle, x_all, arrivals, engine=engine, policy=policy)
    return record


# --smoke supplies these as *defaults* — any explicitly-passed flag wins
SMOKE_DEFAULTS = {"engine": "indexed,bitpack", "classes": 4, "clauses": 64,
                  "features": 48, "requests": 96, "max_batch": 8}
FULL_DEFAULTS = {"engine": "indexed", "classes": 10, "clauses": 256,
                 "features": 196, "requests": 512, "max_batch": 32}


def resolve_flags(smoke: bool, **flags) -> dict:
    """Merge CLI flags with the mode's defaults; an explicit (non-None) flag
    always wins over ``--smoke``'s default set."""
    base = SMOKE_DEFAULTS if smoke else FULL_DEFAULTS
    unknown = set(flags) - set(base)
    if unknown:
        raise ValueError(f"unknown flags {sorted(unknown)}; "
                         f"resolvable: {sorted(base)}")
    return {k: (base[k] if v is None else v) for k, v in flags.items()}


def main(argv=None) -> None:
    """Command-line entry point."""
    ap = argparse.ArgumentParser(description="batched TM serving (PyTorch)")
    ap.add_argument("--engine", default=None,
                    help="comma-separated registry engine names")
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--rps", type=float, default=2000.0)
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--classes", type=int, default=None)
    ap.add_argument("--clauses", type=int, default=None)
    ap.add_argument("--features", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    ap.add_argument("--clause-shards", type=int, default=1,
                    help="ways the clauses split over ranks")
    ap.add_argument("--data-shards", type=int, default=1,
                    help="ways each batch splits over ranks")
    ap.add_argument("--devices", default=None,
                    help="comma-separated devices of the ranks, data-major "
                         "(a device may repeat; default: cuda:0..k-1, or "
                         "cpu with --device cpu)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="BENCH_tm_serve_torch.json")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny defaults; explicit flags still win")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    r = resolve_flags(args.smoke, engine=args.engine, classes=args.classes,
                      clauses=args.clauses, features=args.features,
                      requests=args.requests, max_batch=args.max_batch)
    cfg = TMConfig(n_classes=r["classes"], n_clauses=r["clauses"],
                   n_features=r["features"])
    engines = tuple(r["engine"].split(","))
    for e in engines:
        if e not in registered_engines():
            raise SystemExit(f"unknown engine {e!r}; "
                             f"registered: {registered_engines()}")
    policy = ServePolicy(max_batch=r["max_batch"], max_wait_ms=args.max_wait_ms)
    topology = Topology(clause_shards=args.clause_shards,
                        data_shards=args.data_shards)
    mesh = None
    if topology.is_sharded or args.devices is not None:
        mesh = make_mesh(args.data_shards, args.clause_shards, device=device,
                         devices=(args.devices.split(",")
                                  if args.devices is not None else None))
    record = run(cfg, engines=engines, topology=topology, mesh=mesh,
                 n_requests=r["requests"], rps=args.rps, policy=policy,
                 seed=args.seed, device=device)
    record["schema"] = 1
    with open(args.out, "w") as f:
        json.dump(record, f, indent=2)
    dev = record["device"]
    topo = record["topology"]
    print(f"device: {dev['kind']} ({dev['platform']}), "
          f"route={topo['backend']}, {topo['data_shards']} data x "
          f"{topo['clause_shards']} clause shards "
          f"({topo['composition']})")
    for name, e in record["engines"].items():
        lm = e["latency_ms"]
        tag = ("  [SATURATED: offered load > capacity; percentiles are "
               "backlog, lower --rps]" if e["saturated"] else "")
        print(f"{name}: p50={lm['p50']:.3f}ms p95={lm['p95']:.3f}ms "
              f"p99={lm['p99']:.3f}ms thru={e['throughput_rps']:.1f}req/s "
              f"pad_eff={e['padding_efficiency']}{tag}")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
