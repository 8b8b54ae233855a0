"""Synthetic data (the port's own copy of the generators in
``repro.data.synthetic``): distribution-matched stand-ins for the paper's
TM datasets — binarized MNIST/F-MNIST images (class templates with ~20-40%
active bits and per-pixel flip noise) and IMDb bags of words (~1% active
terms, the sparsity behind the paper's 0.006 work ratio) — and the LM
scaffold's Zipfian token stream. Seeded numpy, so both packages see the
same data.
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


def bow_documents(n, o, n_classes=2, *, active_frac=0.01, signal=40, seed=0):
    """IMDb-like sparse bag-of-words → (x (n, o) uint8, y (n,) int32): a
    shared random background of ``active_frac·o`` terms per document plus a
    quarter of its class's ``signal`` terms."""
    rng = np.random.default_rng(seed)
    n_active = max(4, int(active_frac * o))
    y = rng.integers(0, n_classes, n).astype(np.int32)
    sig = rng.integers(0, o, (n_classes, signal))
    x = np.zeros((n, o), np.uint8)
    for i in range(n):
        x[i, rng.integers(0, o, n_active)] = 1
        take = rng.integers(0, signal, max(2, signal // 4))
        x[i, sig[y[i], take]] = 1
    return x, y


def token_stream(n_tokens, vocab, *, seed=0, ngram=8, n_patterns=512):
    """Zipfian tokens (int32) with injected repeated n-grams: the learnable
    signal of the LM training examples."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    toks = rng.choice(vocab, size=n_tokens, p=probs).astype(np.int32)
    patterns = rng.choice(vocab, size=(n_patterns, ngram), p=probs)
    n_inject = n_tokens // (ngram * 4)
    pos = rng.integers(0, max(1, n_tokens - ngram), n_inject)
    pat = rng.integers(0, n_patterns, n_inject)
    for p, q in zip(pos, pat):
        toks[p:p + ngram] = patterns[q]
    return toks
