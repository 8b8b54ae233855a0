"""Synthetic TM data (the port's own copy of the image generators in
``repro.data.synthetic``): distribution-matched stand-ins for the paper's
binarized MNIST/F-MNIST images — class templates with ~20-40% active bits
and per-pixel flip noise. Seeded numpy, so both packages see the same data.
"""
from __future__ import annotations

import numpy as np


def templated_images(templates, n, *, noise=0.05, rng):
    """Draw n noisy samples from fixed class templates → (x uint8, y int32)."""
    n_classes, o = templates.shape
    y = rng.integers(0, n_classes, n).astype(np.int32)
    flip = rng.uniform(size=(n, o)) < noise
    x = templates[y] ^ flip
    return x.astype(np.uint8), y


def binarized_images(n, o, n_classes=10, *, active=0.3, noise=0.05, seed=0):
    """Class-template Bernoulli images → (x (n, o) uint8, y (n,) int32)."""
    rng = np.random.default_rng(seed)
    templates = rng.uniform(size=(n_classes, o)) < active
    return templated_images(templates, n, noise=noise, rng=rng)
