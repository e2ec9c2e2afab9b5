"""repro_torch, chip_smoke.py and the port's examples (``examples/torch_*.py``)
import neither JAX nor the JAX package."""
import os
import subprocess
import sys
from pathlib import Path

from repro_torch.testing import pin_cpu_threads, thread_env

pin_cpu_threads()

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r'''
import importlib, importlib.util, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "repro")

class Block:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"blocked import of {name!r}")
        return None

sys.meta_path.insert(0, Block())

import repro_torch
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
for path in sys.argv[1:]:  # chip_smoke.py and the port's examples
    spec = importlib.util.spec_from_file_location(path.rsplit("/", 1)[-1][:-3], path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))

from repro_torch.core.samplers.algorithm2 import Algorithm2Sampler
from repro_torch.fl.aggregation import flatten_params
from repro_torch.fl.partition import by_class_shards
from repro_torch.fl.server import FederatedServer, FLConfig
from repro_torch.models.simple import init_mlp
from repro_torch.optim.sgd import sgd

ds = by_class_shards(n_classes=4, clients_per_class=2, train_per_client=20,
                     test_per_client=5, dim=8, seed=0)
params = init_mlp((8, 6, 4), seed=0, device="cpu")
d = flatten_params(params).numel()
sampler = Algorithm2Sampler(ds.population, 3, update_dim=d, device="cpu")
cfg = FLConfig(n_rounds=2, n_local_steps=3, batch_size=4)
with FederatedServer(ds, sampler, params, sgd(0.05), cfg, device="cpu") as srv:
    hist = srv.run()
assert len(hist.records) == 2
# the round and the store sharded over two CPU shards (repro_torch.launch.mesh)
sampler = Algorithm2Sampler(ds.population, 3, update_dim=d, device="cpu", store_mesh_spec="2x1")
cfg = FLConfig(n_rounds=2, n_local_steps=3, batch_size=4, mesh_spec="2x1")
with FederatedServer(ds, sampler, params, sgd(0.05), cfg, device="cpu") as srv:
    hist = srv.run()
assert len(hist.records) == 2 and srv.mesh.shape == {"data": 2, "model": 1}
loaded = sorted(m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED))
assert not loaded, loaded
print("ISOLATED")
'''


def test_port_imports_no_jax_and_no_reference():
    env = thread_env(dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(ROOT / "chip_smoke.py"),
         *sorted(str(p) for p in (ROOT / "examples").glob("torch_*.py"))],
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "ISOLATED" in out.stdout
