"""Deterministic TM batch stream (the port's own numpy copy of
``repro.data.pipeline.TMBatcher``): a batch is a pure function of
(seed, step), so a restarted run replays the exact batch sequence from its
checkpointed step, and both packages see the same batches.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.synthetic import templated_images


class TMBatcher:
    """Deterministic (seed, step) → TM batch {"x": (B, o) uint8, "y": (B,)}.

    Class-template Bernoulli images with the templates fixed by ``seed`` and
    the per-step noise a pure function of (seed, step). (The reference's
    data-shard slicing comes with multi-device topologies.)
    """

    def __init__(self, n_features: int, n_classes: int, batch: int, *,
                 seed: int = 0, active: float = 0.3, noise: float = 0.05):
        self.n_features, self.n_classes = n_features, n_classes
        self.batch, self.seed = batch, seed
        self.active, self.noise = active, noise
        rng = np.random.default_rng(seed)
        self._templates = rng.uniform(size=(n_classes, n_features)) < active

    def __call__(self, step: int) -> dict:
        rng = np.random.default_rng(self.seed * 1_000_003 + 7919 * step + 1)
        x, y = templated_images(self._templates, self.batch,
                                noise=self.noise, rng=rng)
        return {"x": x, "y": y}
