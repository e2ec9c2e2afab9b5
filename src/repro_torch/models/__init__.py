"""Models of the paper's FL experiments."""
