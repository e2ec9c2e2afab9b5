"""The paper's experiments on the port: Fig. 1, Fig. 2 and the §3.2 table.

Run as modules from the repository root with ``src`` on the path, e.g.
``python -m repro_torch.benchmarks.fig1_controlled [--device cpu]``.
"""
