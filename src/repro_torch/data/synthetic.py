# Copied from src/repro/data/synthetic.py.
"""Synthetic datasets standing in for MNIST / CIFAR10 (offline container).

The paper's claims concern *sampling statistics and convergence shape* under
heterogeneous federated partitions, not pixel statistics — we reproduce the
exact federated structure (100 clients, 10 classes, the unbalanced size
profile, Dirichlet partitioning) over class-conditional Gaussian mixtures
whose class overlap is controlled by ``noise``. Recorded in EXPERIMENTS.md
next to each figure.
"""
from __future__ import annotations

import numpy as np


def make_classification_data(
    n_samples: int,
    n_classes: int = 10,
    dim: int = 64,
    noise: float = 1.0,
    seed: int = 0,
    class_of: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Class-conditional Gaussians: x ~ N(mu_c, noise² I), mu_c ~ N(0, I).

    Returns float32 features (n_samples, dim) and int32 labels. ``class_of``
    optionally fixes each sample's label (used by the partitioners, which
    decide labels first and then materialize features).
    """
    rng = np.random.default_rng(seed)
    # class means drawn once from a fixed RNG so every client shares geometry
    mu = np.random.default_rng(12345).normal(size=(n_classes, dim)) * 2.0
    if class_of is None:
        class_of = rng.integers(0, n_classes, size=n_samples)
    y = np.asarray(class_of, dtype=np.int32)
    x = mu[y] + noise * rng.normal(size=(len(y), dim))
    return x.astype(np.float32), y
