"""Plain PyTorch and NumPy references of what the timed path computes.

Imports nothing of the port (``repro_torch``), of the JAX package
(``repro``) or of ``jax``: every number is worked out again from the
benchmark's own inputs (:mod:`perfbench.generate`).
"""
