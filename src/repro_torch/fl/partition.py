# Copied from src/repro/fl/partition.py.
"""Federated partitioners reproducing the paper's experimental settings.

* ``by_class_shards`` — the controlled MNIST setting of Fig. 1: each client
  owns exactly one digit; 10 clients per digit; balanced sample counts.
* ``dirichlet_labels`` — the CIFAR10 setting of Fig. 2 / Appendix D: each
  client's class mixture drawn from Dir(alpha); unbalanced sizes with the
  paper's profile 10×100, 30×250, 30×500, 20×750, 10×1000 train samples and
  test = train/5.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.federated import ClientData, FederatedDataset
from repro_torch.data.synthetic import make_classification_data

PAPER_SIZE_PROFILE: tuple[tuple[int, int], ...] = (
    (10, 100),
    (30, 250),
    (30, 500),
    (20, 750),
    (10, 1000),
)


def by_class_shards(
    n_classes: int = 10,
    clients_per_class: int = 10,
    train_per_client: int = 500,
    test_per_client: int = 100,
    dim: int = 64,
    noise: float = 1.0,
    seed: int = 0,
) -> FederatedDataset:
    """Fig. 1 setting: client c owns only class ``c // clients_per_class``."""
    clients = []
    for c in range(n_classes * clients_per_class):
        cls = c // clients_per_class
        ytr = np.full(train_per_client, cls)
        yte = np.full(test_per_client, cls)
        xtr, ytr = make_classification_data(
            len(ytr), n_classes, dim, noise, seed=seed * 100003 + 2 * c, class_of=ytr
        )
        xte, yte = make_classification_data(
            len(yte), n_classes, dim, noise, seed=seed * 100003 + 2 * c + 1, class_of=yte
        )
        clients.append(ClientData(xtr, ytr, xte, yte))
    return FederatedDataset(clients)


def dirichlet_class_mixtures(
    n_clients: int, n_classes: int, alpha: float, seed: int
) -> np.ndarray:
    """Per-client class mixture π_c ~ Dir(alpha·1). alpha=0 -> one-hot."""
    rng = np.random.default_rng(seed)
    if alpha <= 0:
        mixtures = np.zeros((n_clients, n_classes))
        mixtures[np.arange(n_clients), rng.integers(0, n_classes, n_clients)] = 1.0
        return mixtures
    return rng.dirichlet(np.full(n_classes, alpha), size=n_clients)


def dirichlet_labels(
    alpha: float,
    n_classes: int = 10,
    size_profile: tuple[tuple[int, int], ...] = PAPER_SIZE_PROFILE,
    dim: int = 64,
    noise: float = 1.0,
    seed: int = 0,
) -> FederatedDataset:
    """Fig. 2 setting: Dir(alpha) class mixtures over the unbalanced profile."""
    sizes = [n for count, n in size_profile for _ in range(count)]
    n_clients = len(sizes)
    mixtures = dirichlet_class_mixtures(n_clients, n_classes, alpha, seed)
    rng = np.random.default_rng(seed + 1)
    clients = []
    for c, n_train in enumerate(sizes):
        n_test = max(n_train // 5, 1)
        ytr = rng.choice(n_classes, size=n_train, p=mixtures[c])
        yte = rng.choice(n_classes, size=n_test, p=mixtures[c])
        xtr, ytr = make_classification_data(
            n_train, n_classes, dim, noise, seed=seed * 100003 + 2 * c, class_of=ytr
        )
        xte, yte = make_classification_data(
            n_test, n_classes, dim, noise, seed=seed * 100003 + 2 * c + 1, class_of=yte
        )
        clients.append(ClientData(xtr, ytr, xte, yte))
    return FederatedDataset(clients)
