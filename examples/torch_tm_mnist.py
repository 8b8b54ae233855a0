"""End-to-end example of the PyTorch port (the paper's experiment): a TM on
MNIST-like data, on one NVIDIA GPU (or the CPU).

    PYTHONPATH=src python examples/torch_tm_mnist.py [--epochs 5] [--clauses 512]
    PYTHONPATH=src python examples/torch_tm_mnist.py --device cpu --clauses 64
    PYTHONPATH=src python examples/torch_tm_mnist.py --clause-shards 4 \\
        --devices cuda:0,cuda:0,cuda:0,cuda:0

The port of ``examples/tm_mnist.py``. Full flow: synthetic binarized-MNIST
stream → sequential (paper-faithful) TM learning through the topology-aware
estimator (``--clause-shards`` / ``--data-shards`` run the same script
sharded, bit-exactly) → event-driven engine-cache maintenance → per-epoch
accuracy and samples/s → per-engine µs/sample and the work ratio →
versioned checkpoint save / restore round-trip (schema v1: state + config
fingerprint; caches rebuild on the loading topology; the checkpoint is the
reference package's format too).

A sharded topology takes ``cuda:0 … cuda:k-1`` unless ``--devices`` lists
its devices; a device may repeat (``cuda:0,cuda:0`` runs two shards on one
card: the port's counterpart of the reference's forced host devices), and
the run then says so. Shards on one card run one after another, so their
times are never a multi-card figure.
"""
from __future__ import annotations

import argparse
import tempfile
import time

import torch

from repro_torch.core import (
    TMConfig, Topology, TsetlinMachine, get_engine, include_mask)
from repro_torch.core.indexing import dense_work, indexed_work
from repro_torch.data.synthetic import binarized_images
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.tm_serve import placement


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def parse_args(argv=None) -> argparse.Namespace:
    """The reference example's flags, plus ``--device`` and ``--devices``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--clauses", type=int, default=256)
    ap.add_argument("--features", type=int, default=784)
    ap.add_argument("--train", type=int, default=2048)
    ap.add_argument("--test", type=int, default=512)
    ap.add_argument("--clause-shards", type=int, default=1)
    ap.add_argument("--data-shards", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary one, "
                         "removed at the end)")
    ap.add_argument("--engines", default=None,
                    help="comma-separated engine names (default: registry)")
    ap.add_argument("--max-events", type=int, default=1 << 19,
                    help="cache-sync event buffer capacity per step "
                         "(overflow raises, never silently dropped)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    ap.add_argument("--devices", default=None,
                    help="comma-separated devices of the shards, e.g. "
                         "cuda:0,cuda:0 (may repeat a device)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the example; returns what it printed, as numbers."""
    args = parse_args(argv)
    if args.ckpt_dir is not None:
        return run(args, args.ckpt_dir)
    with tempfile.TemporaryDirectory(prefix="repro_torch_tm_ckpt_") as tmp:
        return run(args, tmp)


def run(args: argparse.Namespace, ckpt_dir: str) -> dict:
    """The example's flow, checkpointing into ``ckpt_dir``."""
    cfg = TMConfig(n_classes=10, n_clauses=args.clauses,
                   n_features=args.features, n_states=127, s=10.0,
                   threshold=25)
    x, y = binarized_images(args.train + args.test, cfg.n_features,
                            10, active=0.3, noise=0.02, seed=1)
    x_tr, y_tr = x[:args.train], y[:args.train]
    x_te, y_te = x[args.train:], y[args.train:]

    engines = tuple(args.engines.split(",")) if args.engines else None
    topology = Topology(clause_shards=args.clause_shards,
                        data_shards=args.data_shards, engines=engines)
    mesh = None
    if topology.is_sharded or args.devices is not None:
        pool = args.devices.split(",") if args.devices is not None else None
        k = topology.n_devices
        if pool is not None and len(pool) < k:
            raise SystemExit(f"--devices lists {len(pool)} device(s); "
                             f"{args.clause_shards} x {args.data_shards} "
                             f"shards need {k}")
        mesh = make_mesh(args.data_shards, args.clause_shards,
                         device=args.device,
                         devices=pool[:k] if pool is not None else None)
    # Full-batch epochs cross many TA boundaries per step, but nowhere near
    # the n_classes·n_clauses·n_literals worst case. Size the buffer to the
    # expected load and let the overflow check (every epoch) catch an
    # undersized buffer loudly instead of leaving stale caches.
    machine = TsetlinMachine(cfg, topology=topology, mesh=mesh, seed=42,
                             max_events_per_batch=args.max_events,
                             device=args.device).init()
    dev = machine.device
    engines = machine.engines
    # sharded caches can't build on the fly: evaluate through a maintained one
    eval_engine = "indexed" if "indexed" in engines else engines[0]
    where = placement(mesh.devices) if mesh is not None else f"1 shard on {dev}"
    print("topology:", machine.session.describe(), f"({where})")

    out = {"placement": where, "train": args.train,
           "max_events": args.max_events, "epochs": [], "us_per_sample": {}}
    for epoch in range(args.epochs):
        before = include_mask(cfg, machine.state)
        _sync(dev)
        t0 = time.perf_counter()
        machine.partial_fit(x_tr, y_tr)
        _sync(dev)
        dt = time.perf_counter() - t0
        if machine.event_overflow:
            raise RuntimeError(
                f"event buffer overflowed ({machine.event_overflow} dropped "
                "events: the caches are stale): raise --max-events")
        events = int((include_mask(cfg, machine.state) != before).sum())
        acc = machine.evaluate(x_te, y_te, engine=eval_engine)
        print(f"epoch {epoch}: acc={acc:.3f}  train {args.train / dt:.0f} "
              f"samples/s  ({events} cache events of {args.max_events})")
        out["epochs"].append({"acc": acc, "samples_per_s": args.train / dt,
                              "events": events})
        machine.save(ckpt_dir, step=epoch, keep=2)

    # inference engine comparison (the paper's Table-4 style measurement),
    # driven through the registry: new engines show up automatically
    print("\ninference engines on", args.test, "samples:")
    x_dev = torch.as_tensor(x_te, device=dev)
    for engine in engines:
        machine.scores(x_dev, engine=engine)              # warm up
        _sync(dev)
        t0 = time.perf_counter()
        machine.scores(x_dev, engine=engine)
        _sync(dev)
        us = (time.perf_counter() - t0) / args.test * 1e6
        out["us_per_sample"][engine] = us
        print(f"  {engine:12s}: {us:8.3f} us/sample")

    idx = machine.bundle.caches.get("indexed")
    if idx is None or machine.session.is_sharded:
        # --engines left 'indexed' out, or the maintained cache is a
        # shard-local layout: build a global index once for the work ratio
        idx = get_engine("indexed").prepare(cfg, machine.state)
    w = float(indexed_work(idx, x_dev).double().mean())
    out["work_ratio"] = w / dense_work(cfg)
    print(f"\nwork ratio: {out['work_ratio']:.4f} "
          "(paper reports ≈0.02 on trained MNIST TMs)")

    # versioned checkpoint round-trip: always restores on one device,
    # whatever the training topology (reshard-on-restore)
    restored = TsetlinMachine.load(ckpt_dir, cfg, device=dev)
    same = torch.equal(restored.predict(x_te, engine=eval_engine).to(dev),
                       machine.predict(x_te, engine=eval_engine))
    out["roundtrip_ok"] = same
    print("checkpoint restore round-trip:", "ok" if same else "MISMATCH")
    return out


if __name__ == "__main__":
    main()
