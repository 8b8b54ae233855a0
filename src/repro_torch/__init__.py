"""PyTorch + CUDA port of the clause-indexed Tsetlin Machine (``repro``).

Online training (sequential or batch-parallel) with every engine cache
kept in sync and the dense, bitpack and indexed engines, on one device or
clause- and data-sharded over a mesh of devices (ragged shard widths,
asynchronous stale votes); the session and estimator facades, schema-v1
checkpoints shared with the reference package, the continuous-batching
server and the fault-tolerant trainer; and the LM scaffold (every model
family, serving and training: ``models``, ``steps``, ``optim``,
``launch``). On a CUDA device the learning round and the bitpack and indexed
engines run through hand-written Hopper kernels (``csrc/*.cu``); on the CPU
through their plain PyTorch versions. Entry points default to
``device="cuda"`` and raise without a card unless the caller passes
``device="cpu"``.
"""
from repro_torch.core import (
    TMBundle, TMConfig, TMSession, TMState, Topology, TsetlinMachine,
    bundle_predict, bundle_scores, init_bundle)

__all__ = ["TMBundle", "TMConfig", "TMSession", "TMState", "Topology",
           "TsetlinMachine", "bundle_predict", "bundle_scores", "init_bundle"]
