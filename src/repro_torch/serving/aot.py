"""Bucket cache: every padding bucket is ready before the first request.

Port of ``repro.serving.aot``. The server declares its padding buckets up
front and the hot loop only ever calls a callable prepared for one of them.
PyTorch runs eagerly, so "ahead of time" means: for every (engine, bucket)
``TMSession.lower_scores`` resolves the engine's cache into a bound callable
and :meth:`AOTBucketCache.warmup` runs it once (building the CUDA kernels
and paying every first-call cost there). ``lowerings`` stays constant after
construction, and a shape that was not prepared raises ``AOTCacheMiss``.

Entries are keyed on ``(engine, bucket, session fingerprint)``; the
fingerprint covers config × placement × devices (``TMSession.fingerprint``).
On a sharded session a bucket callable is one ``make_sharded_scores`` call
over every rank's cache, resolved once when the entry is prepared.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch


def buckets(max_batch: int, min_batch: int = 1) -> list[int]:
    """Power-of-two padding buckets in [min_batch, max_batch].

    ``min_batch`` is the topology's data-shard count: every bucket is a
    multiple of it (a sharded scores call splits the rows over the data
    ranks), and a top bucket that is not one rounds *down* to one.
    """
    if min_batch > max_batch:
        raise ValueError(
            f"max_batch={max_batch} < data shards={min_batch}: every "
            "batch must divide over the data axis — raise max_batch or "
            "serve with fewer data shards")
    out = [min_batch]
    while out[-1] < max_batch:
        nxt = min(out[-1] * 2, max_batch)
        if nxt % min_batch:
            nxt = max(min_batch, (nxt // min_batch) * min_batch)
            if nxt == out[-1]:
                break
        out.append(nxt)
    return out


def bucket_for(n: int, sizes: list[int]) -> int:
    """Smallest bucket in ``sizes`` (ascending) holding ``n`` rows."""
    for b in sizes:
        if b >= n:
            return b
    return sizes[-1]


class AOTCacheMiss(KeyError):
    """A scores callable was requested for a shape that was never prepared —
    the serving invariant (no new work in the hot loop) would be violated,
    so the lookup fails loudly instead."""


@dataclasses.dataclass(frozen=True)
class _Entry:
    fn: object          # (bucket, n_features) uint8 on the device -> scores
    prepare_s: float    # lower_scores: cache resolution + binding


class AOTBucketCache:
    """Every (engine × padding bucket) scores callable, prepared up front.

    >>> cache = AOTBucketCache(session, bundle, engines=("indexed",),
    ...                        max_batch=32)
    >>> scores = cache(x_padded, engine="indexed", bucket=32)

    ``__call__`` is the hot path: a dict lookup, a copy of the host batch to
    the session's device (asynchronous when the host buffer is pinned), and
    the bound callable. It returns the device tensor without waiting for the
    device.
    """

    def __init__(self, session, bundle, *, engines=("indexed",),
                 bucket_sizes=None, max_batch: int = 32,
                 warmup: bool = True):
        if bucket_sizes is None:
            bucket_sizes = buckets(max_batch,
                                   min_batch=session.topology.data_shards)
        self.bucket_sizes = sorted({int(b) for b in bucket_sizes})
        self.engines = tuple(engines)
        self.fingerprint = session.fingerprint()
        self.n_features = session.cfg.n_features
        self.device = session.device
        self.lowerings = 0   # constant after __init__ — the hot-loop assert
        self.hits = 0
        self.misses = 0
        self._warm_s: dict[tuple[str, int], float] = {}
        self._entries: dict[tuple[str, int, str], _Entry] = {}
        for engine in self.engines:
            for b in self.bucket_sizes:
                t0 = time.perf_counter()
                fn = session.lower_scores(bundle, b, engine=engine)
                self.lowerings += 1
                self._entries[(engine, b, self.fingerprint)] = _Entry(
                    fn=fn, prepare_s=time.perf_counter() - t0)
        if warmup:
            self.warmup()

    def __call__(self, x, *, engine: str, bucket: int) -> torch.Tensor:
        """Dispatch one padded ``(bucket, n_features)`` uint8 host batch;
        raises ``AOTCacheMiss`` for keys that were never prepared."""
        entry = self._entries.get((engine, bucket, self.fingerprint))
        if entry is None:
            self.misses += 1
            raise AOTCacheMiss(
                f"no prepared scores for engine={engine!r} bucket={bucket} "
                f"fingerprint={self.fingerprint} (buckets: "
                f"{self.bucket_sizes}, engines: {self.engines})")
        self.hits += 1
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint8))
        return entry.fn(x.to(self.device, non_blocking=True))

    def warmup(self) -> None:
        """Run every entry once on zeros and wait for the device: kernel
        builds and first-call costs land here, not in the timed loop.
        Excluded from the hit counter."""
        hits = self.hits
        for engine in self.engines:
            for b in self.bucket_sizes:
                t0 = time.perf_counter()
                x = np.zeros((b, self.n_features), np.uint8)
                self(x, engine=engine, bucket=b).cpu()
                self._warm_s[(engine, b)] = time.perf_counter() - t0
        self.hits = hits

    def compile_report(self) -> dict:
        """Per-engine ``{bucket: seconds}`` of preparation plus the warm-up
        call (string bucket keys, as the reference's JSON records use)."""
        out = {}
        for (engine, b, _), e in sorted(self._entries.items(),
                                        key=lambda kv: (kv[0][0], kv[0][1])):
            out.setdefault(engine, {})[str(b)] = round(
                e.prepare_s + self._warm_s.get((engine, b), 0.0), 4)
        return out

    def counters(self) -> dict:
        """Cache counters: ``lowerings`` must equal ``entries`` and stay
        constant across serving; ``misses`` must stay 0."""
        return {"engines": len(self.engines),
                "buckets": len(self.bucket_sizes),
                "entries": len(self._entries),
                "lowerings": self.lowerings,
                "hits": self.hits,
                "misses": self.misses}
