"""The port's sketch stage against the JAX package's: hash bits, SRP, countsketch, registry."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sketch import ref as R
from repro.kernels.sketch.kernel import srp_sketch_kernel
from repro_torch.kernels.sketch import SKETCHERS, Sketcher, resolve_sketcher
from repro_torch.kernels.sketch import ops
from repro_torch.kernels.sketch import ref as P
from repro_torch.kernels.sketch.ops import CountSketcher, IdentitySketcher, SRPSketcher, srp_sketch
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

# 12_345 · 0x165667B1 exceeds 2**32, so its salted seed term wraps
SEEDS = [0, 7, 2**31 - 1, 12_345]


def _rand(n, d, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def test_mul32_matches_uint32_wraparound():
    h = np.random.default_rng(0).integers(0, 2**32, size=100_000, dtype=np.uint64).astype(np.uint32)
    h[:3] = [0, 1, 2**32 - 1]
    for c in (P._C1, P._C2, P._K_SALT, P._J_SALT, P._SEED_SALT):
        want = (h * np.uint32(c)).astype(np.int64)
        np.testing.assert_array_equal(P._mul32(torch.from_numpy(h.astype(np.int64)), c).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize(
    "k0,bd,d_prime,d_total",
    [
        (0, 64, 32, 64),        # one whole block
        (0, 64, 32, 40),        # ragged tail: rows 40.. are zero
        (512, 512, 64, 700),    # an offset block with a tail past d
        (39_424, 512, 64, 39_760),  # the MLP's last block, 336 rows of it real
    ],
)
def test_sign_block_bit_equal(seed, k0, bd, d_prime, d_total):
    want = R.srp_sign_block(seed, k0, bd, d_prime, d_total)
    got = P.srp_sign_block(seed, k0, bd, d_prime, d_total, device="cpu").numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("d,d_prime", [(257, 31), (39_760, 64)])
def test_countsketch_params_bit_equal(seed, d, d_prime):
    want_b, want_s = R.countsketch_params(d, d_prime, seed)
    got_b, got_s = P.countsketch_params(d, d_prime, seed, device="cpu")
    np.testing.assert_array_equal(got_b.numpy(), want_b)
    np.testing.assert_array_equal(got_s.numpy().view(np.uint32), want_s.view(np.uint32))


@pytest.mark.parametrize(
    "n,d,d_prime,block_n,block_d",
    [
        (13, 1037, 64, 8, 256),
        (32, 512, 16, 16, 512),
        (8, 96, 8, 8, 32),
        (128, 300, 32, 128, 128),
    ],
)
def test_srp_matches_reference_kernel(n, d, d_prime, block_n, block_d):
    X = _rand(n, d, seed=n + d)
    want = np.asarray(srp_sketch_kernel(jnp.asarray(X), d_prime=d_prime, seed=7, block_n=block_n,
                                        block_d=block_d, interpret=True))
    got = srp_sketch(torch.from_numpy(X), d_prime, 7, block_d=block_d)
    assert tuple(got.shape) == (n, d_prime) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), R.sketch_srp_reference(X, d_prime, 7, block_d=block_d),
                               rtol=1e-5, atol=1e-5)


def test_srp_block_size_invariant():
    """Other d-blocks sum in other orders: the same result to f32."""
    X = _rand(17, 700, seed=3)
    want = np.asarray(srp_sketch_kernel(jnp.asarray(X), d_prime=24, seed=1, block_n=8, block_d=64,
                                        interpret=True))
    for bd in (64, 128, 512):
        got = P.sketch_srp_plain(torch.from_numpy(X), 24, 1, block_d=bd).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_srp_seed_changes_projection():
    X = torch.from_numpy(_rand(6, 128))
    a, b = srp_sketch(X, 16, 0), srp_sketch(X, 16, 1)
    assert not torch.allclose(a, b)
    assert torch.equal(a, srp_sketch(X, 16, 0))


def test_countsketch_matches_reference():
    X = _rand(9, 257, seed=5)
    want = R.sketch_countsketch_reference(X, 31, 2)
    got = CountSketcher(257, 31, seed=2)(torch.from_numpy(X))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_countsketch_index_lists_each_bucket_in_order():
    bucket, _ = P.countsketch_params(257, 31, 2, device="cpu")
    idx = P.countsketch_index(bucket, 31).numpy()
    for b in range(31):
        row = idx[b][idx[b] < 257]
        np.testing.assert_array_equal(row, np.flatnonzero(bucket.numpy() == b))
        assert np.all(idx[b][len(row):] == 257)


def test_split_plan_covers_d_once():
    """Every k-tile lies in exactly one split, the splits come in whole
    groups, and d = 39,760 gets 128 splits of 5 k-tiles (3 of them empty)."""
    for d in (39_760, 1037, 96, 1, 100_000, 8193):
        splits, per = ops.split_plan(d)
        n_tiles = -(-d // ops.TK)
        assert splits % ops.GROUP == 0 and per >= 1
        assert splits == (ops.SPLITS if n_tiles >= ops.SPLITS else ops.GROUP * -(-n_tiles // ops.GROUP))
        assert (per - 1) * splits < n_tiles <= splits * per
    assert ops.split_plan(39_760) == (128, 5)


def test_srp_wrapper_rejects_bad_input():
    with pytest.raises(TypeError):
        srp_sketch(torch.zeros((2, 8), dtype=torch.float64), 4, 0)
    with pytest.raises(ValueError):
        srp_sketch(torch.zeros(8), 4, 0)
    with pytest.raises(ValueError):
        srp_sketch(torch.zeros((0, 8)), 4, 0)
    with pytest.raises(ValueError):
        srp_sketch(torch.zeros((2, 8)), 0, 0)


# --------------------------------------------------------------------------
# sketchers, registry and resolution (the contract of tests/test_sketch.py)
# --------------------------------------------------------------------------
def test_identity_sketcher_returns_same_object():
    sk = SKETCHERS.get("identity")(32)
    X = torch.from_numpy(_rand(4, 32))
    assert sk(X) is X
    assert (sk.d_in, sk.d_out) == (32, 32)


def test_identity_rejects_compressing_dim():
    with pytest.raises(ValueError, match="identity"):
        SKETCHERS.get("identity")(32, 8)


def test_srp_sketcher_matches_reference_sketcher():
    from repro.kernels.sketch.ops import SRPSketcher as RefSRP

    X = _rand(5, 300, seed=9)
    got = SRPSketcher(300, 12, seed=4)(torch.from_numpy(X))
    np.testing.assert_allclose(got.numpy(), RefSRP(300, 12, seed=4).reference(X), rtol=1e-5, atol=1e-5)


def test_registry_unknown_name_lists_options():
    with pytest.raises(ValueError, match="identity"):
        SKETCHERS.get("nope")


def test_registry_register_and_override():
    def factory(d_in, d_prime=None, *, seed=0):
        return IdentitySketcher(d_in, d_in, seed)

    SKETCHERS.register("_test_sk", factory)
    try:
        assert SKETCHERS.get("_test_sk") is factory
        with pytest.raises(ValueError, match="already registered"):
            SKETCHERS.register("_test_sk", factory)
        SKETCHERS.register("_test_sk", factory, override=True)
    finally:
        SKETCHERS.unregister("_test_sk")
    assert "_test_sk" not in SKETCHERS


def test_registry_names_match_reference():
    from repro.kernels.sketch import SKETCHERS as REF

    assert SKETCHERS.names() == REF.names()


def test_resolve_sketcher_contract():
    assert resolve_sketcher(None, 64) is None
    sk = resolve_sketcher("srp", 64, 8, seed=3)
    assert (sk.d_in, sk.d_out, sk.seed) == (64, 8, 3)
    assert resolve_sketcher(sk, 64) is sk
    with pytest.raises(ValueError, match="d_in"):
        resolve_sketcher(sk, 128)
    with pytest.raises(ValueError, match="sketch_dim"):
        resolve_sketcher("srp", 64)
    with pytest.raises(ValueError, match="1 <= d_prime"):
        resolve_sketcher("countsketch", 64, 0)
    with pytest.raises(ValueError, match="1 <= d_prime"):
        resolve_sketcher("srp", 64, 65)


def test_sketcher_base_is_abstract():
    with pytest.raises(NotImplementedError):
        Sketcher(4, 4, 0)(torch.zeros((1, 4)))


# the numpy host references and each sketcher's .reference
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n,d,d_prime,block_d", [(5, 300, 12, 512), (3, 1037, 64, 128), (7, 96, 8, 40)])
def test_srp_reference_bit_equal(n, d, d_prime, block_d, seed):
    """The port's numpy SRP reference against the reference's, bit for bit:
    the same S blocks (the hash) applied by numpy in the same block order."""
    X = _rand(n, d, seed=seed % 97)
    got = P.sketch_srp_reference(X, d_prime, seed, block_d=block_d)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_array_equal(got, R.sketch_srp_reference(X, d_prime, seed, block_d=block_d))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n,d,d_prime", [(5, 300, 12), (3, 1037, 64), (7, 96, 8)])
def test_countsketch_reference_bit_equal(n, d, d_prime, seed):
    X = _rand(n, d, seed=seed % 89)
    got = P.sketch_countsketch_reference(X, d_prime, seed)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_array_equal(got, R.sketch_countsketch_reference(X, d_prime, seed))


@pytest.mark.parametrize("name,d_prime", [("identity", None), ("srp", 16), ("countsketch", 16)])
@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_every_sketcher_reference_bit_equal(name, d_prime, as_tensor):
    """Each sketcher's ``.reference`` returns numpy, bit-equal to the
    reference sketcher's ``.reference`` on a numpy X or on a tensor (copied
    to the host first); identity hands a numpy X back as it is."""
    from repro.kernels.sketch.ops import SKETCHERS as REF_SKETCHERS

    X = _rand(6, 200, seed=3)
    sk = SKETCHERS.get(name)(200, d_prime, seed=5)
    want = REF_SKETCHERS.get(name)(200, d_prime, seed=5).reference(X)
    got = sk.reference(torch.from_numpy(X) if as_tensor else X)
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, want)
    if name == "identity" and not as_tensor:
        assert got is X
    with pytest.raises(NotImplementedError):
        Sketcher(4, 4, 0).reference(X)
