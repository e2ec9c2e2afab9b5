"""The port's sketched gradient store against the JAX package's, update by update."""
import numpy as np
import pytest
import torch

from repro.fl.gradient_store import GradientStore as RefStore
from repro_torch.fl.gradient_store import GradientStore
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()


def _sequence(d, seed=0):
    """Four update blocks with duplicate ids and the sentinels 8 and 9."""
    rng = np.random.default_rng(seed)
    for _ in range(4):
        yield rng.integers(0, 10, size=6), rng.normal(size=(6, d)).astype(np.float32)


@pytest.mark.parametrize("sketch,sketch_dim", [("srp", 8), ("countsketch", 8), ("identity", None)])
@pytest.mark.parametrize("decay", [1.0, 0.75])
def test_sketched_store_matches_reference(sketch, sketch_dim, decay):
    d = 200
    ref = RefStore(8, d, staleness_decay=decay, sketch=sketch, sketch_dim=sketch_dim, sketch_seed=3)
    got = GradientStore(8, d, staleness_decay=decay, sketch=sketch, sketch_dim=sketch_dim,
                        sketch_seed=3, device="cpu")
    assert (got.dim, got.nbytes) == (ref.dim, ref.nbytes)
    for ids, vals in _sequence(d):
        ref.update(ids, vals)
        got.update(ids, torch.from_numpy(vals))
    ids, vals = next(_sequence(d, seed=1))
    ref.scatter_scaled(ids, vals, scale=0.5)
    got.scatter_scaled(ids, vals, scale=0.5)
    np.testing.assert_allclose(got.asnumpy(), ref.asnumpy(), rtol=1e-5, atol=1e-5)


def test_identity_sketch_is_bitwise_unsketched():
    plain = GradientStore(6, 12, staleness_decay=0.9, device="cpu")
    ident = GradientStore(6, 12, staleness_decay=0.9, sketch="identity", device="cpu")
    assert ident.dim == 12 and ident.nbytes == plain.nbytes
    for ids, vals in _sequence(12, seed=2):
        ids = ids % 7  # ids 6 are sentinels here
        plain.update(ids, vals)
        ident.update(ids, vals)
    np.testing.assert_array_equal(plain.asnumpy(), ident.asnumpy())


def test_sketched_store_resident_shape_and_bytes():
    store = GradientStore(10, 256, sketch="srp", sketch_dim=16, device="cpu")
    assert (store.dim, store.update_dim, store.nbytes) == (16, 256, 10 * 16 * 4)
    store.update(np.array([3]), np.ones((1, 256), np.float32))
    snap = store.snapshot()
    assert tuple(snap.shape) == (10, 16)
    assert bool((snap[3] != 0).any()) and bool((snap[[0, 1, 2, 4]] == 0).all())
    with pytest.raises(ValueError, match="updates shape"):
        store.update(np.array([0]), np.ones((1, 16), np.float32))


def test_all_rows_dropped_is_a_no_op():
    store = GradientStore(4, 32, sketch="srp", sketch_dim=4, device="cpu")
    store.update([4, 5], np.ones((2, 32), np.float32))
    store.scatter_scaled([7], np.ones((1, 32), np.float32))
    assert not store.asnumpy().any()


def test_sketch_seed_changes_resident_rows():
    vals = np.ones((1, 64), np.float32)
    a = GradientStore(3, 64, sketch="srp", sketch_dim=8, sketch_seed=0, device="cpu")
    b = GradientStore(3, 64, sketch="srp", sketch_dim=8, sketch_seed=1, device="cpu")
    a.update([0], vals)
    b.update([0], vals)
    assert not np.allclose(a.asnumpy()[0], b.asnumpy()[0])


@pytest.mark.parametrize("sketch,sketch_dim", [(None, None), ("srp", 4)])
def test_empty_scatter_checks_its_width_first(sketch, sketch_dim):
    """An empty update of the wrong width raises, as in the reference; an
    empty one of the right width is a no-op."""
    ref = RefStore(6, 12, sketch=sketch, sketch_dim=sketch_dim, backend="numpy")
    got = GradientStore(6, 12, sketch=sketch, sketch_dim=sketch_dim, device="cpu")
    bad = np.zeros((0, 5), np.float32)
    with pytest.raises(ValueError) as want:
        ref.scatter_scaled(np.empty(0, np.int64), bad, scale=0.5)
    with pytest.raises(ValueError) as err:
        got.scatter_scaled(np.empty(0, np.int64), torch.from_numpy(bad), scale=0.5)
    assert str(err.value) == str(want.value)
    before = got.asnumpy().copy()
    got.scatter_scaled(np.empty(0, np.int64), torch.zeros(0, 12), scale=0.5)
    np.testing.assert_array_equal(got.asnumpy(), before)
