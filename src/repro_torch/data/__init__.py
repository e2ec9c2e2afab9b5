"""Synthetic federated datasets (numpy), bit-equal to ``repro.data``'s."""
