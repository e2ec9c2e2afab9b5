"""The port's mesh helpers (``repro_torch.launch.mesh``) against the JAX
package's ``repro.launch.mesh``.

The spec forms and their errors are held to the reference on a one-device
JAX mesh (this process has one CPU device). The axis helpers read only a
mesh's ``axis_names`` and ``shape``, so the reference's own functions are
called on the port's multi-shard CPU meshes too. Ceil blocks are GSPMD's:
each group ⌈n / groups⌉ rows, the trailing ones short or empty.
"""
import numpy as np
import pytest
import torch

from repro.launch import mesh as ref_mesh
from repro_torch.launch import mesh
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

SPECS = [None, "auto", "1x1", "1", "1X1", (1, 1), [1, 1], (1,), [1]]
BAD = ["2y1", "x1", "1x", "", "axb", "1x1x1", (1, 1, 1), [], 3, 2.5, {"data": 1}]


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_resolve_fl_mesh_spec_forms_as_the_reference(spec):
    want = ref_mesh.resolve_fl_mesh(spec)
    got = mesh.resolve_fl_mesh(spec, device="cpu")
    if want is None:
        assert got is None
        return
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape)
    assert mesh.mesh_chips(got) == ref_mesh.mesh_chips(want)
    assert all(d == torch.device("cpu") for d in got.devices.flat)


@pytest.mark.parametrize("spec", BAD, ids=str)
def test_resolve_fl_mesh_errors_as_the_reference(spec):
    with pytest.raises(ValueError) as want:
        ref_mesh.resolve_fl_mesh(spec)
    with pytest.raises(ValueError) as got:
        mesh.resolve_fl_mesh(spec, device="cpu")
    assert str(got.value) == str(want.value)


def test_a_mesh_passes_through_and_cpu_shards_are_built():
    m = mesh.make_host_mesh(4, 2, device="cpu")
    assert mesh.resolve_fl_mesh(m, device="cpu") is m
    assert m.shape == {"data": 4, "model": 2} and m.devices.shape == (4, 2)
    assert mesh.resolve_fl_mesh("4x2", device="cpu").shape == m.shape
    assert mesh.resolve_fl_mesh((3,), device="cpu").shape == {"data": 3, "model": 1}
    # the reference's host mesh of more devices than there are raises; the
    # port's CPU shards are as many as asked for
    with pytest.raises(ValueError, match="must be >="):
        ref_mesh.resolve_fl_mesh("4x1")
    with pytest.raises(RuntimeError, match="device='cpu'") if not torch.cuda.is_available() \
            else pytest.raises(ValueError, match="must be >="):
        mesh.make_host_mesh(64, 1)
    pod = mesh.make_production_mesh(multi_pod=True)
    assert pod.shape == {"pod": 2, "data": 16, "model": 16}
    assert mesh.data_parallel_degree(pod) == 32 and mesh.mesh_chips(pod) == 512


def _pod_mesh():
    devs = np.empty(2 * 3 * 2, dtype=object)
    devs[:] = [torch.device("cpu")] * devs.size
    return mesh.Mesh(devs.reshape(2, 3, 2), ("pod", "data", "model"))


@pytest.mark.parametrize("shape", [(1, 1), (4, 1), (4, 2), (2, 3), "pod"], ids=str)
def test_axis_helpers_equal_the_references(shape):
    m = _pod_mesh() if shape == "pod" else mesh.make_host_mesh(*shape, device="cpu")
    assert mesh.batch_axes(m) == ref_mesh.batch_axes(m)
    assert mesh.data_parallel_degree(m) == ref_mesh.data_parallel_degree(m)
    assert mesh.mesh_chips(m) == ref_mesh.mesh_chips(m)
    for ndim in (1, 2, 4):
        assert mesh.leading_batch_spec(m, ndim) == tuple(ref_mesh.leading_batch_spec(m, ndim))
    groups = mesh.data_groups(m)
    assert len(groups) == mesh.data_parallel_degree(m)
    assert sum(len(g) for g in groups) == mesh.mesh_chips(m)
    assert mesh.group_devices(m) == [g[0] for g in groups]


def test_axis_helpers_on_a_one_device_jax_mesh():
    want = ref_mesh.make_host_mesh(1, 1)
    got = mesh.make_host_mesh(1, 1, device="cpu")
    assert mesh.batch_axes(got) == ref_mesh.batch_axes(want)
    assert mesh.data_parallel_degree(got) == ref_mesh.data_parallel_degree(want) == 1
    assert mesh.leading_batch_spec(got, 3) == tuple(ref_mesh.leading_batch_spec(want, 3))


@pytest.mark.parametrize("n,parts,sizes", [(10, 4, [3, 3, 3, 1]), (8, 4, [2, 2, 2, 2]),
                                           (5, 4, [2, 2, 1, 0]), (3, 4, [1, 1, 1, 0]),
                                           (1, 1, [1]), (7, 2, [4, 3])])
def test_ceil_blocks(n, parts, sizes):
    spans = mesh.blocks(n, parts)
    assert [hi - lo for lo, hi in spans] == sizes
    assert spans[0][0] == 0 and all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] == n
    assert all(hi - lo == -(-n // parts) for lo, hi in spans if hi < n)


def test_lead_device_checks():
    cpu = mesh.make_host_mesh(2, 1, device="cpu")
    assert mesh.lead_device(cpu) == torch.device("cpu")
    mesh.check_lead(cpu, "cpu", "x")
    card = mesh.Mesh(np.array([[torch.device("cuda", 1)]], dtype=object), mesh.AXES)
    assert not mesh.same_device("cpu", torch.device("cuda", 0))
    assert mesh.same_device(torch.device("cuda", 1), torch.device("cuda", 1))
    with pytest.raises(ValueError, match="the store runs on cpu but the mesh's lead device is cuda:1"):
        mesh.check_lead(card, "cpu", "the store")


def test_placements_name_the_references_specs():
    m = mesh.make_host_mesh(4, 1, device="cpu")
    p = mesh.Placement(m, mesh.leading_batch_spec(m, 4))
    assert p.mesh is m and p.spec == ("data", None, None, None)


def test_sharded_rows_slice_select_and_gather():
    rows = torch.arange(20, dtype=torch.float32).reshape(10, 2)
    blocks = [rows[0:3], rows[3:6], rows[6:9], rows[9:10]]
    sr = mesh.ShardedRows(blocks, 2)
    assert sr.shape == (10, 2) and len(sr) == 10 and sr.groups == [0, 1, 2, 3]
    torch.testing.assert_close(sr.gather("cpu"), rows, rtol=0, atol=0)
    head = sr[:7]
    assert head.groups == [0, 1, 2] and [b.shape[0] for b in head.blocks] == [3, 3, 1]
    torch.testing.assert_close(head.gather("cpu"), rows[:7], rtol=0, atol=0)
    keep = np.array([1, 0, 1, 0, 0, 0, 1, 1, 1, 0], dtype=bool)
    for mask in (keep, torch.as_tensor(keep)):
        picked = sr[mask]
        assert picked.groups == [0, 2]
        torch.testing.assert_close(picked.gather("cpu"), rows[keep], rtol=0, atol=0)
    empty = sr[np.zeros(10, dtype=bool)]
    assert empty.shape == (0, 2) and empty.gather("cpu").shape == (0, 2)
    with pytest.raises(IndexError):
        sr[::2]
    with pytest.raises(IndexError):
        sr[np.ones(3, dtype=bool)]


def test_on_shard_tallies_the_position_and_restores_it():
    from repro_torch.kernels import _build

    assert _build.set_shard(None) is None
    with mesh.on_shard(2, "cpu"):
        with mesh.on_shard(5, "cpu"):
            _build.tally("aggregate")
        _build.tally("aggregate")
    _build.tally("aggregate")  # outside a shard: not tallied
    assert _build.shard_launches[("aggregate", 5)] >= 1
    assert _build.shard_launches[("aggregate", 2)] >= 1
    assert _build.set_shard(None) is None
