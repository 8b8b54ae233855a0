"""The paper's own experiment configs (§4): MNIST / F-MNIST / IMDb grids.

The port's own copy of ``repro.configs.tm``. M1–M4, F1–F4: binarized
images at 1–4 threshold bits (o = 784·bits); I1–I4: bag-of-words at
o ∈ {5k, 10k, 15k, 20k}.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.types import TMConfig


@dataclasses.dataclass(frozen=True)
class TMExperiment:
    """One paper configuration and the sparsity statistics it implies."""

    name: str
    tm: TMConfig
    dataset: str          # "image" | "bow"
    # sparsity stats used by synthetic data + the work-ratio analysis
    avg_clause_len: float # paper §3: MNIST ≈ 58, IMDb ≈ 116


def mnist_like(bits: int = 1, n_clauses: int = 2000) -> TMExperiment:
    """MNIST at ``bits`` threshold bits per pixel (paper M1–M4)."""
    o = 784 * bits
    return TMExperiment(
        name=f"M{bits}",
        tm=TMConfig(n_classes=10, n_clauses=n_clauses, n_features=o,
                    n_states=127, s=10.0, threshold=50),
        dataset="image", avg_clause_len=58.0)


def fmnist_like(bits: int = 1, n_clauses: int = 2000) -> TMExperiment:
    """Fashion-MNIST (paper F1–F4): the MNIST shapes."""
    return dataclasses.replace(mnist_like(bits, n_clauses),
                               name=f"F{bits}")


def imdb_like(o: int = 5000, n_clauses: int = 2000) -> TMExperiment:
    """IMDb bag-of-words over ``o`` terms (paper I1–I4)."""
    return TMExperiment(
        name=f"I{o//5000}",
        tm=TMConfig(n_classes=2, n_clauses=n_clauses, n_features=o,
                    n_states=127, s=27.0, threshold=40),
        dataset="bow", avg_clause_len=116.0)


PAPER_TM_CONFIGS = {
    "tm_mnist": mnist_like(1),
    "tm_fashion_mnist": fmnist_like(1),
    "tm_imdb": imdb_like(5000),
}
