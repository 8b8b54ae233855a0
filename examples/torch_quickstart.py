"""Quickstart of the PyTorch port: train a Tsetlin Machine with clause
indexing on one NVIDIA GPU (or the CPU) in a few seconds.

    PYTHONPATH=src python examples/torch_quickstart.py                # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The port of ``examples/quickstart.py``: a small multiclass TM on synthetic
binarized images through the topology-aware ``TsetlinMachine`` estimator.
Every registered evaluation engine (exhaustive dense, bitpack, clause-compact
gather, and the paper's falsification index, Eq. 4) is kept in step
event-wise during learning and gives identical predictions. On the card the
bitpack and indexed engines and the learning round run the port's CUDA
kernels.

The ``topology=`` below is the default one-device placement; a sharded one,
for example ``Topology(clause_shards=2)`` with ``mesh=make_mesh(1, 2,
devices=["cuda:0"] * 2)``, runs the same script bit-exactly.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import (
    TMConfig, Topology, TsetlinMachine, registered_engines)
from repro_torch.core.indexing import dense_work, indexed_work
from repro_torch.data.synthetic import binarized_images


def main(argv=None) -> dict:
    """Run the quickstart; returns the accuracies, predictions and work
    ratio it printed."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)

    cfg = TMConfig(n_classes=4, n_clauses=64, n_features=64, n_states=63,
                   s=5.0, threshold=12)
    # Event buffer sized to the observed load (a few thousand crossings on
    # the first full-batch step), not the 32k worst case: the overflow
    # counter, asserted after every epoch, turns an undersized buffer from
    # silently stale caches into a loud failure.
    machine = TsetlinMachine(cfg, topology=Topology(), seed=0,
                             max_events_per_batch=8192,
                             device=args.device).init()

    x, y = binarized_images(1024, cfg.n_features, cfg.n_classes,
                            active=0.35, noise=0.03, seed=0)
    x_tr, y_tr = x[:768], y[:768]
    x_te, y_te = x[768:], y[768:]

    accs = []
    for epoch in range(3):
        machine.partial_fit(x_tr, y_tr)          # caches synced event-wise
        if machine.event_overflow:
            raise RuntimeError(
                f"event buffer overflowed ({machine.event_overflow} dropped): "
                "raise max_events_per_batch")
        acc = machine.evaluate(x_te, y_te, engine="indexed")
        accs.append(acc)
        print(f"epoch {epoch}: test acc (indexed inference) = {acc:.3f}")

    preds = {name: machine.predict(x_te, engine=name)
             for name in registered_engines()}
    for name, p in preds.items():
        if not torch.equal(p, preds["dense"]):
            raise RuntimeError(f"{name} != dense")
    print(f"all engines agree: {' == '.join(preds)}")

    x_dev = torch.as_tensor(x_te, device=machine.device)
    w = float(indexed_work(machine.index, x_dev).double().mean())
    ratio = w / dense_work(cfg)
    print(f"work ratio (paper §3 Remarks): {ratio:.4f} "
          "(fraction of exhaustive literal inspections)")
    return {"accuracy": accs,
            "predictions": {k: v.cpu().numpy() for k, v in preds.items()},
            "work_ratio": ratio, "event_overflow": machine.event_overflow}


if __name__ == "__main__":
    main()
