"""Weighted sum of stacked flat client models (eq. 3/4)."""
