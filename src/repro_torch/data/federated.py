# Copied from src/repro/data/federated.py.
"""Federated dataset container: per-client train/test arrays + population."""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.types import ClientPopulation


@dataclasses.dataclass
class ClientData:
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray

    @property
    def n_train(self) -> int:
        return len(self.y_train)


@dataclasses.dataclass
class FederatedDataset:
    clients: list[ClientData]

    @property
    def n_clients(self) -> int:
        return len(self.clients)

    @property
    def population(self) -> ClientPopulation:
        return ClientPopulation(np.array([c.n_train for c in self.clients]))

    def global_test(self) -> tuple[np.ndarray, np.ndarray]:
        xs = np.concatenate([c.x_test for c in self.clients])
        ys = np.concatenate([c.y_test for c in self.clients])
        return xs, ys

    def class_of_client(self) -> np.ndarray:
        """Majority class per client (used by oracle 'target' grouping)."""
        return np.array(
            [np.bincount(c.y_train, minlength=10).argmax() for c in self.clients]
        )
