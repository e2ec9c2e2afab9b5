"""Pairwise Gram / L1 sums over representative gradients (Algorithm 2 line 2)."""
