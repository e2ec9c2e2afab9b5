# Copied from src/repro/data/__init__.py.
"""Synthetic federated datasets (numpy), bit-equal to ``repro.data``'s."""
from repro_torch.data.synthetic import make_classification_data
from repro_torch.data.federated import ClientData, FederatedDataset
from repro_torch.data.tokens import TokenBatch, TokenPipeline

__all__ = [
    "make_classification_data",
    "ClientData",
    "FederatedDataset",
    "TokenBatch",
    "TokenPipeline",
]
