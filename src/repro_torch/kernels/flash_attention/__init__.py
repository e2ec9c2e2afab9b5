"""Causal GQA flash attention, forward (kernel B4)."""
