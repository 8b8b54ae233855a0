"""TM serving CLI (port of ``repro.launch.tm_serve``): the closed-loop
``run``, the open-loop ``run_sustained`` and the ``run_batch_axis_scaling``
sweep.

    PYTHONPATH=src python -m repro_torch.launch.tm_serve --smoke
    PYTHONPATH=src python -m repro_torch.launch.tm_serve --engine indexed,bitpack
    PYTHONPATH=src python -m repro_torch.launch.tm_serve --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.tm_serve --smoke \
        --clause-shards 2 --data-shards 2 --devices cuda:0,cuda:0,cuda:0,cuda:0

Runs on the card unless ``--device cpu`` is given. The record,
``BENCH_tm_serve_torch.json`` (schema 2, git-ignored; the fields of
``docs/BENCH_SCHEMAS.md`` §``BENCH_tm_serve.json``), holds:

  * ``engines`` — per engine, a synthetic closed-loop load: a simulated
    arrival clock advanced by *measured* batch times (deterministic per
    seed, no sleeps). Its percentiles are clean per-batch latency under
    that load; its throughput splices compute windows end to end and is
    not a wall-clock rate.
  * ``sustained_load`` (absent with ``--no-sustained``) — the open-loop
    comparison (``serving/loadgen.py``): per engine a ``SyncTMServer`` is
    ramped ×4 to saturation, then an ``AsyncTMServer`` sweeps an
    offered-rate ladder (``ASYNC_LADDER``) scaled to that baseline, with
    the same Poisson generator on the same wall clock; the knee, the
    speedup at the knee and the bucket cache's hot-loop counters.
  * ``batch_axis_scaling`` (absent with ``--no-scaling``) — the closed-loop
    load again at 1, 2, 4, … data shards over the device pool: the
    ``--devices`` list (which may repeat a device), else the distinct
    devices present (so one card sweeps only 1 shard). Each row names its
    devices: shards that share a device read "k shards on one card",
    never as scaling.

``--clause-shards`` / ``--data-shards`` serve through a sharded session
(``core/distributed.py``); the ranks take the first ``C·D`` devices of
``--devices``, else ``cuda:0 … cuda:k-1`` (or the CPU with ``--device
cpu``). Unlike the reference, ``--data-shards`` defaults to 1 rather than
to every spare device, and there is no ``--backend``: the device picks the
kernel. The record's ``topology`` is ``session.describe()``.
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
from repro_torch.serving import (
    AOTBucketCache, AsyncTMServer, SyncTMServer, bucket_for, buckets,
    holds, run_step, sustained_load)


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


def _saturation_rps(server, xs: np.ndarray, *, step_duration_s: float,
                    rng: np.random.Generator,
                    start_rps: float = 250.0) -> tuple[float, list[dict]]:
    """Ramp offered load ×4 until the server stops holding it.

    An overloaded open-loop step keeps the server continuously busy, so the
    achieved rate of the first step that does not hold is the server's
    capacity; the max achieved across the ramp is returned to absorb step
    noise.
    """
    steps, rate = [], start_rps
    while rate <= 4e6:
        step = run_step(server, xs, rps=rate, duration_s=step_duration_s,
                        rng=rng)
        steps.append(step)
        if not holds(step):
            break
        rate *= 4
    return max(s["achieved_rps"] for s in steps), steps


# offered-rate ladder for the async sweep, as multiples of the measured
# sync baseline — dense around 1.0 so the knee resolves whether the async
# runtime clears the baseline, with overload steps past it
ASYNC_LADDER = (0.4, 0.8, 1.05, 1.3, 1.8, 2.6)


def run_sustained(cfg: TMConfig, *, engines=("indexed",),
                  topology: Topology | None = None,
                  mesh: DeviceMesh | None = None, max_batch: int = 32,
                  step_duration_s: float = 1.0, seed: int = 0,
                  include_density: float = 0.08, device="cuda") -> dict:
    """The open-loop sync-vs-async comparison (the ``sustained_load``
    section of the schema-2 record).

    Per engine: a ``SyncTMServer`` (the blocking drain loop behind the same
    submit surface) is ramped to saturation, then an ``AsyncTMServer`` over
    a shared bucket cache sweeps an offered ladder scaled to that baseline.
    Both run through the same Poisson generator on the same wall clock, so
    ``knee_exceeds_sync`` is a fair comparison. Each step also records the
    rate the generator actually submitted at (``submitted_rps``).
    """
    rng = np.random.default_rng(seed)
    session = TMSession(cfg, topology, mesh=mesh, engines=engines,
                        device=device)
    bundle = session.prepare(_random_state(cfg, rng, include_density))
    xs, _ = binarized_images(512, cfg.n_features, cfg.n_classes,
                             seed=seed + 1)
    aot = AOTBucketCache(session, bundle, engines=tuple(engines),
                         max_batch=max_batch)
    out = {"step_duration_s": step_duration_s,
           "ladder": list(ASYNC_LADDER),
           "device": device_record(session.device), "engines": {}}
    for engine in engines:
        sync = SyncTMServer(session, bundle, engine=engine,
                            max_batch=max_batch).start()
        try:
            base, ramp = _saturation_rps(
                sync, xs, step_duration_s=step_duration_s,
                rng=np.random.default_rng(seed + 2))
        finally:
            sync.stop()

        server = AsyncTMServer(session, bundle, engine=engine,
                               max_batch=max_batch, aot=aot)
        try:
            rec = sustained_load(server, xs,
                                 rps_steps=[m * base for m in ASYNC_LADDER],
                                 step_duration_s=step_duration_s,
                                 seed=seed + 3)
        finally:
            server.stop()

        rec["sync_baseline"] = {
            "achieved_rps": base,
            "ramp": [{k: s[k] for k in ("offered_rps", "achieved_rps",
                                        "rejection_rate", "submitted_rps")}
                     for s in ramp]}
        rec["knee_exceeds_sync"] = bool(rec["knee"]["achieved_rps"] > base)
        rec["speedup_at_knee"] = (
            round(rec["knee"]["achieved_rps"] / base, 3) if base else None)
        out["engines"][engine] = rec
    out["compile_s_per_bucket"] = aot.compile_report()
    out["knee_exceeds_sync"] = all(
        r["knee_exceeds_sync"] for r in out["engines"].values())
    return out


def placement(devices) -> str:
    """How shards sit on devices, in words: "k shards on one card (cuda:0)"
    when they share a device, "k shards on k devices" otherwise."""
    distinct = list(dict.fromkeys(str(d) for d in devices))
    k = len(devices)
    if len(distinct) == 1:
        where = "card" if distinct[0].startswith("cuda") else "device"
        return (f"1 shard on {distinct[0]}" if k == 1
                else f"{k} shards on one {where} ({distinct[0]})")
    return f"{k} shards on {len(distinct)} devices ({', '.join(distinct)})"


def run_batch_axis_scaling(cfg: TMConfig, *, engine: str = "indexed",
                           devices=None, device="cuda",
                           n_requests: int = 256, rps: float = 2000.0,
                           policy: ServePolicy = ServePolicy(),
                           seed: int = 0,
                           include_density: float = 0.08) -> list[dict]:
    """The same closed-loop load at 1, 2, 4, … data shards
    (``Topology(data_shards=d)`` over ``make_mesh``), up to the device pool
    and ``max_batch``; shard count d takes the first d devices of the pool:
    ``devices`` as given (a device may repeat), else the distinct devices
    present (every card, or the one CPU with ``device="cpu"``).

    Each row names its devices: ``mesh`` (one entry per shard),
    ``devices`` (how many *distinct* devices those are: unlike the
    reference's rows, where it equals ``data_shards``) and ``placement``.
    Shards on one device run one after another, so such a row measures k
    shards on one card, never scaling.
    """
    if devices is not None:
        pool = [resolve_device(d) for d in devices]
    elif resolve_device(device).type == "cpu":
        pool = [torch.device("cpu")]
    else:
        pool = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    out = []
    d = 1
    while d <= min(len(pool), policy.max_batch):
        mesh = make_mesh(d, 1, devices=pool[:d])
        rec = run(cfg, engines=(engine,), topology=Topology(data_shards=d),
                  mesh=mesh, n_requests=n_requests, rps=rps, policy=policy,
                  seed=seed, include_density=include_density)
        r = rec["engines"][engine]
        out.append({"devices": len(set(mesh.devices)), "data_shards": d,
                    "mesh": [str(x) for x in mesh.devices],
                    "placement": placement(mesh.devices), "engine": engine,
                    "throughput_rps": r["throughput_rps"],
                    "p50_ms": r["latency_ms"]["p50"],
                    "p95_ms": r["latency_ms"]["p95"],
                    "saturated": r["saturated"]})
        d *= 2
    return out


# --smoke supplies these as *defaults* — any explicitly-passed flag wins
SMOKE_DEFAULTS = {"engine": "indexed,bitpack", "classes": 4, "clauses": 64,
                  "features": 48, "requests": 96, "max_batch": 8,
                  "step_duration": 0.3}
FULL_DEFAULTS = {"engine": "indexed", "classes": 10, "clauses": 256,
                 "features": 196, "requests": 512, "max_batch": 32,
                 "step_duration": 1.0}


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
                    help="comma-separated device pool, data-major (a device "
                         "may repeat): the ranks take the first C·D, the "
                         "scaling sweep prefixes of it (default: cuda:0.."
                         "k-1, or cpu with --device cpu)")
    ap.add_argument("--step-duration", type=float, default=None,
                    help="seconds per open-loop load step (sustained_load)")
    ap.add_argument("--no-sustained", action="store_true",
                    help="skip the open-loop sync-vs-async sustained_load "
                         "sweep")
    ap.add_argument("--no-scaling", action="store_true",
                    help="skip the per-shard-count batch-axis sweep")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="BENCH_tm_serve_torch.json")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny defaults; explicit flags still win")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    r = resolve_flags(args.smoke, engine=args.engine, classes=args.classes,
                      clauses=args.clauses, features=args.features,
                      requests=args.requests, max_batch=args.max_batch,
                      step_duration=args.step_duration)
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
    pool = args.devices.split(",") if args.devices is not None else None
    mesh = None
    if topology.is_sharded or pool is not None:
        k = topology.n_devices
        if pool is not None and len(pool) < k:
            raise SystemExit(f"--devices lists {len(pool)} device(s); "
                             f"{args.clause_shards} x {args.data_shards} "
                             f"shards need {k}")
        mesh = make_mesh(args.data_shards, args.clause_shards, device=device,
                         devices=pool[:k] if pool is not None else None)
    record = run(cfg, engines=engines, topology=topology, mesh=mesh,
                 n_requests=r["requests"], rps=args.rps, policy=policy,
                 seed=args.seed, device=device)
    record["schema"] = 2
    if not args.no_sustained:
        record["sustained_load"] = run_sustained(
            cfg, engines=engines, topology=topology, mesh=mesh,
            max_batch=policy.max_batch, step_duration_s=r["step_duration"],
            seed=args.seed, device=device)
    if not args.no_scaling:
        record["batch_axis_scaling"] = run_batch_axis_scaling(
            cfg, engine=engines[0], devices=pool, device=device,
            n_requests=(r["requests"] if args.smoke
                        else min(r["requests"], 256)),
            rps=args.rps, policy=policy, seed=args.seed)
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
    for name, s in record.get("sustained_load", {}).get("engines", {}).items():
        knee = s["knee"]
        print(f"sustained[{name}]: sync={s['sync_baseline']['achieved_rps']}"
              f"req/s · async knee={knee['achieved_rps']}req/s at offered "
              f"{knee['offered_rps']} (submitted "
              f"{s['steps'][knee['index']]['submitted_rps']}; "
              f"{s['speedup_at_knee']}x sync, exceeds="
              f"{s['knee_exceeds_sync']}, hot-loop compiles="
              f"{s['aot']['hot_loop_compiles']})")
    for row in record.get("batch_axis_scaling", []):
        print(f"scaling[{row['engine']}] data_shards={row['data_shards']} "
              f"({row['placement']}): thru={row['throughput_rps']:.1f}req/s "
              f"p95={row['p95_ms']:.3f}ms")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
