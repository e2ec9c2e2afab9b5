"""Optimizers over dicts of tensors, in ``repro.optim``'s (init, update) shape."""
