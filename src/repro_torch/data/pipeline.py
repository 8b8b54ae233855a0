"""Deterministic batch streams and background prefetch (the port's own
copies of ``repro.data.pipeline``'s ``TokenBatcher``, ``TMBatcher`` and
``Prefetcher``): a batch is a pure function of (seed, step), so a
restarted run replays the exact batch sequence from its checkpointed step,
and both packages see the same batches; ``Prefetcher`` prepares the next
batches on a host thread while the device works on the current step.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np

from repro_torch.data.synthetic import templated_images, token_stream


class TokenBatcher:
    """Deterministic (seed, step) → LM batch {"tokens", "labels"}, each
    (B, S) int32 numpy, labels the tokens shifted by one. ``shard_index`` /
    ``shard_count`` give this shard's ``B / shard_count`` rows, drawn from
    a stream of its own (the reference's folding of (seed, step, shard)
    into the stream's seed)."""

    def __init__(self, vocab: int, batch: int, seq: int, *, seed: int = 0,
                 shard_index: int = 0, shard_count: int = 1):
        if shard_count < 1 or batch % shard_count:
            raise ValueError(f"batch={batch} must be a multiple of "
                             f"shard_count={shard_count} (>= 1)")
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.seed = seed
        self.shard_index, self.shard_count = shard_index, shard_count
        self.local_batch = batch // shard_count

    def __call__(self, step: int) -> dict:
        n = self.local_batch * (self.seq + 1)
        toks = token_stream(
            n, self.vocab,
            seed=(self.seed * 1_000_003 + step * 613 + self.shard_index))
        toks = toks.reshape(self.local_batch, self.seq + 1)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


class TMBatcher:
    """Deterministic (seed, step) → TM batch {"x": (B, o) uint8, "y": (B,)}.

    Class-template Bernoulli images with the templates fixed by ``seed`` and
    the per-step noise a pure function of (seed, step). ``shard_index`` /
    ``shard_count`` take contiguous row blocks of the *global* batch, so the
    shards of one step concatenate, in shard order, to the one-shard stream
    (each process of a multi-process run reads its own rows).
    """

    def __init__(self, n_features: int, n_classes: int, batch: int, *,
                 seed: int = 0, active: float = 0.3, noise: float = 0.05,
                 shard_index: int = 0, shard_count: int = 1):
        if shard_count < 1 or batch % shard_count:
            raise ValueError(f"batch={batch} must be a multiple of "
                             f"shard_count={shard_count} (>= 1)")
        if not 0 <= shard_index < shard_count:
            raise ValueError(f"shard_index={shard_index} outside "
                             f"[0, {shard_count})")
        self.n_features, self.n_classes = n_features, n_classes
        self.batch, self.seed = batch, seed
        self.active, self.noise = active, noise
        self.shard_index, self.shard_count = shard_index, shard_count
        self.local_batch = batch // shard_count
        rng = np.random.default_rng(seed)
        self._templates = rng.uniform(size=(n_classes, n_features)) < active

    def __call__(self, step: int) -> dict:
        rng = np.random.default_rng(self.seed * 1_000_003 + 7919 * step + 1)
        x, y = templated_images(self._templates, self.batch,
                                noise=self.noise, rng=rng)
        lo = self.shard_index * self.local_batch
        hi = lo + self.local_batch
        return {"x": x[lo:hi], "y": y[lo:hi]}


class Prefetcher:
    """Double-buffered background prefetch of a step-indexed source:
    iterating yields ``(step, source(step))`` from ``start_step`` on, with up
    to ``depth`` steps prepared ahead by a daemon thread. ``close`` stops
    and joins it."""

    def __init__(self, source: Callable[[int], dict], start_step: int = 0,
                 depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def work():
            s = start_step
            while not self._stop.is_set():
                try:
                    self.q.put((s, self.source(s)), timeout=0.2)
                    s += 1
                except queue.Full:
                    continue

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        while True:
            yield self.q.get()

    def close(self) -> None:
        """Stop the worker and wait (up to 2 s) for it to exit."""
        self._stop.set()
        self._thread.join(timeout=2)
