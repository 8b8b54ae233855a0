"""Continuous-batching TM serving runtime (PyTorch port of ``repro.serving``):
the bucket cache (``aot``), the async and sync servers (``runtime``) and
per-tenant weighted round-robin (``fairness``)."""
from repro_torch.serving.aot import (
    AOTBucketCache, AOTCacheMiss, bucket_for, buckets)
from repro_torch.serving.fairness import TenantQueues, TenantStats
from repro_torch.serving.runtime import (
    AsyncTMServer, Backlog, Overloaded, Promise, ScoreResult, SyncTMServer)

__all__ = [
    "AOTBucketCache", "AOTCacheMiss", "AsyncTMServer", "Backlog",
    "Overloaded", "Promise", "ScoreResult", "SyncTMServer", "TenantQueues",
    "TenantStats", "bucket_for", "buckets",
]
