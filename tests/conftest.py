import os
import sys

# tests run against the source tree; smoke tests must see the REAL device
# count (1 CPU device) — the 512-device XLA flag is set ONLY inside
# repro.launch.dryrun / subprocess-based sharding tests.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
# make tests/ importable as a flat namespace (for _hypothesis_compat)
sys.path.insert(0, os.path.dirname(__file__))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc; skips on a machine without them",
    )
