"""Continuous-batching TM serving runtime (PyTorch port of ``repro.serving``):
the bucket cache (``aot``), the async and sync servers (``runtime``),
per-tenant weighted round-robin (``fairness``), and open-loop Poisson load
generation with the ``sustained_load`` record and its knee (``loadgen``)."""
from repro_torch.serving.aot import (
    AOTBucketCache, AOTCacheMiss, bucket_for, buckets)
from repro_torch.serving.fairness import TenantQueues, TenantStats
from repro_torch.serving.loadgen import (
    find_knee, holds, poisson_arrivals, run_step, sustained_load)
from repro_torch.serving.runtime import (
    AsyncTMServer, Backlog, Overloaded, Promise, ScoreResult, SyncTMServer)

__all__ = [
    "AOTBucketCache", "AOTCacheMiss", "AsyncTMServer", "Backlog",
    "Overloaded", "Promise", "ScoreResult", "SyncTMServer", "TenantQueues",
    "TenantStats", "bucket_for", "buckets", "find_knee", "holds",
    "poisson_arrivals", "run_step", "sustained_load",
]
