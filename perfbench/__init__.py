"""The benchmark of ``repro_torch`` on one NVIDIA H100: federated LM rounds
under clustered (Algorithm 2) and MD client sampling.

``python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. A cell names a configuration (``perfbench/configs/<name>.json``)
and a traffic mix (``perfbench/traffic/<name>.json``); a per-layer metric
is a reader in ``perfbench/metrics/<name>.py``. Nothing here imports the
JAX package; ``perfbench/reference`` imports nothing of the port either.
"""
