"""Layers of the LM tier (functional, over dicts of tensors)."""
