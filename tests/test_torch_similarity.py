"""The port's similarity ops against the JAX reference (Pallas interpret mode)."""
import numpy as np
import pytest
import torch

from repro.kernels.similarity.ops import make_distance_fn as ref_make_distance_fn
from repro_torch.kernels.similarity import ops
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

MEASURES = ["arccos", "l2", "l1"]
# (13, 101) is the ragged tier-1 gate; (12, 8300) has d > STREAM_D_THRESHOLD,
# so both packages take their streamed entry point.
SHAPES = [(13, 101), (20, 300), (12, 8300)]


def _G(n, d, seed=0):
    # update scale: G rows are θ_i − θ after lr-scaled SGD steps. At unit
    # scale an f32 L1 sum over 8300 coordinates is ~9e3, whose ulp (~1e-3)
    # alone exceeds the 1e-4 tolerance.
    return (1e-2 * np.random.default_rng(seed).normal(size=(n, d))).astype(np.float32)


@pytest.mark.parametrize("n,d", SHAPES)
@pytest.mark.parametrize("measure", MEASURES)
def test_distances_match_reference(measure, n, d):
    G = _G(n, d)
    want = ref_make_distance_fn(interpret=True)(G, measure)
    got = ops.make_distance_fn()(torch.from_numpy(G), measure)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert (np.diag(got) == 0).all()
    np.testing.assert_array_equal(got, got.T)


@pytest.mark.parametrize("entry", ["device", "streamed"])
@pytest.mark.parametrize("measure", MEASURES)
def test_both_entry_points_agree(measure, entry):
    G = torch.from_numpy(_G(13, 101, seed=1))
    fn = getattr(ops, f"pairwise_distances_{entry}")
    want = ref_make_distance_fn(interpret=True)(G.numpy(), measure)
    np.testing.assert_allclose(fn(G, measure).numpy(), want, atol=1e-4)


@pytest.mark.parametrize("measure", MEASURES)
def test_zero_rows(measure):
    """Never-sampled clients: zero-vs-zero is 0 and, under arccos,
    zero-vs-nonzero is π/2 (``tests/test_kernels.py:52,70``)."""
    G = _G(9, 24, seed=2)
    G[[0, 3, 7]] = 0.0
    want = ref_make_distance_fn(interpret=True)(G, measure)
    got = ops.pairwise_distances_device(torch.from_numpy(G), measure).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert got[0, 3] == 0.0 and got[3, 7] == 0.0
    if measure == "arccos":
        np.testing.assert_allclose(got[0, 1], np.pi / 2, atol=1e-6)
        np.testing.assert_allclose(got[7, 2], np.pi / 2, atol=1e-6)


def test_split_plan_covers_d():
    for n, d in [(13, 101), (100, 39760), (100, 64), (257, 8193), (1, 1), (17, 1001), (3, 10**6)]:
        splits, per = ops.split_plan(n, d)
        n_chunks = -(-d // ops.BK)
        # every split holds a chunk and the splits cover d
        assert splits * per >= n_chunks > (splits - 1) * per
        assert 1 <= splits <= ops.MAX_SPLITS
        assert splits == 1 or per >= ops.MIN_CHUNKS
    # the main path's store: one split and one launch; at model width, 249
    # splits of 5 chunks, added in 32 groups
    assert ops.split_plan(100, 64) == (1, 2)
    assert ops.split_plan(100, 39760) == (249, 5)


def test_wrapper_rejects_bad_input():
    with pytest.raises(TypeError):
        ops.pairwise_sums(torch.zeros(3, 4, dtype=torch.float64), "gram")
    with pytest.raises(ValueError):
        ops.pairwise_sums(torch.zeros(3, 4), "cosine")
    # meta inputs (the dry-run's) give the output's shape and no data
    out = ops.pairwise_sums(torch.zeros(3, 4, device="meta"), "gram")
    assert out.device.type == "meta" and out.shape == (3, 3) and out.dtype == torch.float32


# ---------------------------------------------------------------------------
# the host-chunked path and the backend names
# ---------------------------------------------------------------------------
CHUNK_SHAPE, D_CHUNK = (13, 101), 32  # the reference's ragged gate, d_chunk 32
CHUNK_SIZES = np.array([40, 7, 120, 33, 15, 60, 90, 12, 45, 30, 70, 25, 55])


def _ref_chunked(G, measure):
    from repro.kernels.similarity.ops import pairwise_distances_chunked as ref_chunked

    return np.asarray(ref_chunked(G, measure, block_n=8, block_d=16, d_chunk=D_CHUNK,
                                  interpret=True))


@pytest.mark.parametrize("host", [True, False], ids=["numpy", "tensor"])
@pytest.mark.parametrize("measure", MEASURES)
def test_chunked_matches_reference_chunked_and_one_shot(measure, host):
    """A host numpy G (or a CPU tensor) at the ragged (13, 101) with
    d_chunk 32, against the reference's chunked path and the port's one-shot
    op: distances within atol 1e-4 (the reference's), and Algorithm 2's
    plans built from them token for token equal."""
    from repro.core.samplers.algorithm2 import build_plan_algorithm2 as ref_build
    from repro_torch.core.samplers.algorithm2 import build_plan_algorithm2
    from repro_torch.core.types import ClientPopulation

    G = _G(*CHUNK_SHAPE, seed=5)
    G[[2, 9]] = 0.0  # never-sampled clients
    arg = G if host else torch.from_numpy(G)
    got = ops.pairwise_distances_chunked(arg, measure, d_chunk=D_CHUNK, device="cpu")
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    want = _ref_chunked(G, measure)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), ops.pairwise_distances_device(
        torch.from_numpy(G), measure).numpy(), atol=1e-4)
    np.testing.assert_array_equal(got.numpy(), got.numpy().T)
    pop = ClientPopulation(CHUNK_SIZES)
    plan = build_plan_algorithm2(pop, 4, arg, measure=measure, distance_fn=lambda G, m: (
        ops.pairwise_distances_chunked(G, m, d_chunk=D_CHUNK, device="cpu")))
    ref_plan = ref_build(pop, 4, G, measure=measure, distance_fn=_ref_chunked)
    np.testing.assert_array_equal(plan.r_tokens, ref_plan.r_tokens)
    np.testing.assert_array_equal(plan.cluster_of, ref_plan.cluster_of)


@pytest.mark.parametrize("measure", ["arccos", "l1"])
def test_chunked_never_sees_full_width_block(measure, monkeypatch):
    """As the reference's ``tests/test_kernels.py``: the distance op sees
    (n, <= d_chunk) slabs only, the ragged tail last, one call a slab."""
    widths = []
    real = ops.pairwise_sums

    def spy(G, op):
        widths.append(int(G.shape[1]))
        return real(G, op)

    monkeypatch.setattr(ops, "pairwise_sums", spy)
    G = _G(12, 100, seed=6)
    out = ops.pairwise_distances_chunked(G, measure, d_chunk=D_CHUNK, device="cpu")
    assert widths == [32, 32, 32, 4]
    np.testing.assert_allclose(out.numpy(), ref_make_distance_fn(interpret=True)(G, measure),
                               atol=1e-4)


def test_chunked_runs_on_the_card_by_default():
    """A host G with no device asks for the card, and raises here without
    one; a tensor G stays on its own device."""
    G = _G(5, 40)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ops.pairwise_distances_chunked(G, "arccos")
    assert ops.pairwise_distances_chunked(torch.from_numpy(G), "arccos").device.type == "cpu"
    with pytest.raises(ValueError, match="at least one"):
        ops.pairwise_distances_chunked(np.zeros((3, 0), np.float32), "arccos", device="cpu")


@pytest.mark.parametrize("as_numpy", [True, False])
@pytest.mark.parametrize("backend", ops.DISTANCE_BACKENDS)
def test_every_backend_name_matches_reference(backend, as_numpy):
    """Each name the reference's ``resolve_distance_backend`` takes, on a
    CPU G ("pallas", the compiled TPU kernel there, held to its interpret
    build): the same distances, numpy with ``as_numpy`` and a tensor on G's
    device without (the numpy measure is numpy either way)."""
    from repro.kernels.similarity.ops import resolve_distance_backend as ref_resolve

    G = _G(13, 101, seed=8)
    want = ref_resolve("pallas-interpret" if backend == "pallas" else backend)(G, "arccos")
    got = ops.resolve_distance_backend(backend, as_numpy=as_numpy)(torch.from_numpy(G), "arccos")
    if as_numpy or backend == "numpy":
        assert isinstance(got, np.ndarray)
    else:
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


def test_backend_names_and_host_arrays():
    """The names equal the reference's; only "chunked" and "numpy" take a
    host G, the device modes raise on one; an unknown name raises as the
    reference's does."""
    from repro.kernels.similarity.ops import resolve_distance_backend as ref_resolve

    G = _G(6, 20)
    for name in ("auto", "pallas", "pallas-interpret", "streamed"):
        with pytest.raises(TypeError, match="torch tensor"):
            ops.resolve_distance_backend(name)(G, "arccos")
    if not torch.cuda.is_available():  # a host G goes to the card, which is missing here
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ops.resolve_distance_backend("chunked")(G, "l1")
    got = ops.resolve_distance_backend("chunked")(torch.from_numpy(G), "l1")
    np.testing.assert_allclose(got, ref_resolve("chunked")(G, "l1"), atol=1e-4)
    for resolve in (ref_resolve, ops.resolve_distance_backend):
        with pytest.raises(ValueError, match="unknown distance backend 'bogus'"):
            resolve("bogus")
    assert set(ops.DISTANCE_BACKENDS) == {"auto", "pallas", "pallas-interpret", "streamed",
                                          "chunked", "numpy"}


@pytest.mark.parametrize("kw", [{}, {"streamed": True}, {"d_chunk": 50}, {"chunked": True}],
                         ids=["default", "streamed", "d_chunk", "chunked"])
def test_make_distance_fn_modes_match_reference(kw):
    G = _G(13, 101, seed=9)
    want = ref_make_distance_fn(interpret=True, **kw)(G, "l2")
    got = ops.make_distance_fn(**kw)(torch.from_numpy(G), "l2")
    assert isinstance(got, torch.Tensor)  # the port's default keeps it on G's device
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    np.testing.assert_allclose(ops.make_distance_fn(**kw, as_numpy=True)(torch.from_numpy(G), "l2"),
                               want, atol=1e-4)
