"""Device resolution: no silent CPU fallback, explicit device="cpu" works."""
import shutil

import numpy as np
import pytest
import torch

from repro_torch.core.samplers.algorithm2 import Algorithm2Sampler
from repro_torch.device import resolve_device
from repro_torch.fl.engine import BatchedRoundEngine
from repro_torch.fl.gradient_store import GradientStore
from repro_torch.fl.partition import by_class_shards
from repro_torch.fl.server import FederatedServer, FLConfig
from repro_torch.kernels import _build
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.configs import get_config
from repro_torch.kernels.similarity.ops import pairwise_distances_chunked
from repro_torch.kernels.sketch.ref import countsketch_params, srp_sign_block
from repro_torch.launch.serve import generate
from repro_torch.models.layers.norms import init_layernorm, init_rmsnorm
from repro_torch.models.model import init_cache, init_params
from repro_torch.models.simple import init_mlp
from repro_torch.optim.sgd import sgd
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

DATA = dict(n_classes=4, clients_per_class=1, train_per_client=10, test_per_client=2, dim=8, seed=0)


ENTRY_POINTS = [
    "resolve_device", "init_mlp", "GradientStore", "BatchedRoundEngine",
    "Algorithm2Sampler", "FederatedServer", "srp_sign_block", "countsketch_params",
    "GradientStore[srp]", "Algorithm2Sampler[srp,kmeans]", "init_params[lm]", "init_cache[lm]",
    "generate[lm]", "init_rmsnorm", "init_layernorm", "pairwise_distances_chunked[host]",
]


def _call(name, device):
    """Call entry point ``name`` with ``device`` (None: its default)."""
    ds = by_class_shards(**DATA)
    kw = {} if device is None else {"device": device}
    if name == "resolve_device":
        return resolve_device(**kw)
    if name == "init_mlp":
        return init_mlp((8, 4), **kw)
    if name == "GradientStore":
        return GradientStore(4, 6, **kw)
    if name == "GradientStore[srp]":
        return GradientStore(4, 6, sketch="srp", sketch_dim=3, **kw)
    if name == "init_rmsnorm":
        return init_rmsnorm(8, **kw)
    if name == "init_layernorm":
        return init_layernorm(8, **kw)
    if name == "pairwise_distances_chunked[host]":
        return pairwise_distances_chunked(np.ones((3, 20), np.float32), "arccos", d_chunk=8, **kw)
    if name == "srp_sign_block":
        return srp_sign_block(0, 0, 8, 4, 8, **kw)
    if name == "countsketch_params":
        return countsketch_params(8, 4, 0, **kw)
    if name.endswith("[lm]"):
        cfg = get_config("qwen2-1.5b", reduced=True)
        if name == "init_params[lm]":
            return init_params(cfg, **kw)
        if name == "init_cache[lm]":
            return init_cache(cfg, 1, 4, **kw)
        params = init_params(cfg, device="cpu")
        return generate(cfg, params, torch.zeros((1, 3), dtype=torch.long), 2, **kw)
    if name == "BatchedRoundEngine":
        return BatchedRoundEngine(ds, 2, 1, 2, **kw)
    if name == "Algorithm2Sampler":
        return Algorithm2Sampler(ds.population, 2, update_dim=6, **kw)
    if name == "Algorithm2Sampler[srp,kmeans]":
        return Algorithm2Sampler(ds.population, 2, update_dim=6, sketch="srp", sketch_dim=3,
                                 clusterer="kmeans", **kw)
    params = init_mlp((8, 4), device="cpu")
    sampler = Algorithm2Sampler(ds.population, 2, update_dim=36, device="cpu")
    return FederatedServer(ds, sampler, params, sgd(0.1), FLConfig(n_rounds=1), **kw)


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_default_device_raises_without_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present, so the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        _call(name, None)


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_explicit_cpu_works(name):
    _call(name, "cpu")


def test_unknown_device_type_raises():
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_build_raises_without_nvcc(monkeypatch):
    """Without nvcc the kernel build raises; nothing falls back to the plain
    version."""
    if shutil.which("nvcc"):
        pytest.skip("nvcc is present")
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


def test_build_module_imports_without_nvcc():
    assert set(_build.SOURCES) == {"similarity", "aggregate", "sketch", "flash_attention"}
    for name in _build.SOURCES:
        src, lib = _build._target(name)
        assert src.exists()
        assert lib.parent == _build.BUILD_DIR and lib.name.startswith(f"lib{name}-")


def test_unported_options_raise():
    """The mesh is ported (CPU shards here); what raises is a mesh whose
    lead device is not the caller's. The production mesh is meta positions,
    each a device of its own, whatever the host holds."""
    ds = by_class_shards(**DATA)
    assert BatchedRoundEngine(ds, 2, 1, 2, device="cpu", mesh="2x1").mesh.shape == {"data": 2, "model": 1}
    on_card = Mesh(np.array([[torch.device("cuda", 0)]], dtype=object), ("data", "model"))
    with pytest.raises(ValueError, match="lead device"):
        BatchedRoundEngine(ds, 2, 1, 2, device="cpu", mesh=on_card)
    sampler = Algorithm2Sampler(ds.population, 2, update_dim=36, device="cpu")
    params = init_mlp((8, 4), device="cpu")
    with pytest.raises(ValueError, match="lead device"):
        FederatedServer(ds, sampler, params, sgd(0.1), FLConfig(mesh_spec=on_card), device="cpu")
    with pytest.raises(ValueError, match="lead device"):
        GradientStore(4, 3, mesh_spec=on_card, device="cpu")
    pod = make_production_mesh()
    assert pod.shape == {"data": 16, "model": 16}
    assert {d.type for d in pod.devices.flat} == {"meta"}
    assert len({pod.device_key(p) for p in range(256)}) == 256


def test_staging_budget_falls_back_to_compat():
    ds = by_class_shards(**DATA)
    sampler = Algorithm2Sampler(ds.population, 2, update_dim=36, device="cpu")
    params = init_mlp((8, 4), device="cpu")
    with pytest.warns(UserWarning, match="compat"):
        srv = FederatedServer(ds, sampler, params, sgd(0.1), FLConfig(n_rounds=1, max_staged_bytes=1),
                              device="cpu")
    assert srv._engine is None
    assert len(srv.run().records) == 1


def test_store_update_semantics():
    store = GradientStore(4, 3, staleness_decay=0.5, device="cpu")
    store.update([1, 2], np.ones((2, 3), np.float32))
    store.update([2, 9, 2], np.stack([np.full(3, 2.0), np.full(3, 7.0), np.full(3, 3.0)]).astype(np.float32))
    G = store.asnumpy()
    np.testing.assert_array_equal(G[1], np.full(3, 0.5))  # decayed once
    np.testing.assert_array_equal(G[2], np.full(3, 3.0))  # last write wins
    np.testing.assert_array_equal(G[[0, 3]], 0.0)  # id 9 dropped
    snap = store.snapshot()
    store.scatter_scaled([0], np.ones((1, 3), np.float32), scale=2.0)
    assert snap[0].abs().sum() == 0  # snapshots are copies
    np.testing.assert_array_equal(store.gather_rows([0]).numpy(), np.full((1, 3), 2.0))
