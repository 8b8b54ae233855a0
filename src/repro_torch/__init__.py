"""PyTorch + CUDA port of the clause-indexed Tsetlin Machine (``repro``).

Serving slice: the dense, bitpack and indexed engines, the session and
estimator facades, schema-v1 checkpoints shared with the reference package,
and the continuous-batching server. On a CUDA device the bitpack and
indexed engines score through hand-written Hopper kernels
(``csrc/*.cu``); on the CPU through their plain PyTorch versions. Entry
points default to ``device="cuda"`` and raise without a card unless the
caller passes ``device="cpu"``. Training comes in the next slice.
"""
from repro_torch.core import (
    TMBundle, TMConfig, TMSession, TMState, Topology, TsetlinMachine,
    bundle_predict, bundle_scores, init_bundle)

__all__ = ["TMBundle", "TMConfig", "TMSession", "TMState", "Topology",
           "TsetlinMachine", "bundle_predict", "bundle_scores", "init_bundle"]
