# Copied from src/repro/launch/__init__.py.
"""Command-line drivers of the port."""
from repro_torch.launch.mesh import batch_axes, make_host_mesh, make_production_mesh

__all__ = ["make_production_mesh", "make_host_mesh", "batch_axes"]
