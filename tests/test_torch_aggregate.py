"""The port's aggregate op against the JAX reference (Pallas interpret mode)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl.aggregation import aggregate_stacked as ref_aggregate_stacked
from repro.kernels.aggregate.kernel import aggregate_kernel
from repro_torch.fl.aggregation import aggregate_stacked
from repro_torch.kernels.aggregate import ops
from repro_torch.kernels.aggregate.ops import aggregate_flat, launch_plan
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

RNG = np.random.default_rng(0)


# (41, 39,760): bench_round_engine's m = 40 and θ^t; (11, 39,759): a ragged p
@pytest.mark.parametrize("k,p", [(1, 64), (7, 1000), (11, 12345), (41, 39760), (11, 39759)])
def test_aggregate_matches_reference_kernel(k, p):
    U = RNG.normal(size=(k, p)).astype(np.float32)
    w = RNG.normal(size=(k,)).astype(np.float32)
    want = np.asarray(aggregate_kernel(jnp.asarray(U), jnp.asarray(w), block_p=512, interpret=True))
    got = aggregate_flat(torch.from_numpy(U), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def _stacked(c, seed):
    rng = np.random.default_rng(seed)
    shapes = {"w0": (16, 8), "b0": (8,), "w1": (8, 10), "b1": (10,)}
    glob = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    stacked = {k: rng.normal(size=(c,) + s).astype(np.float32) for k, s in shapes.items()}
    return glob, stacked


def test_stale_row_matches_reference_aggregate_stacked():
    glob, stacked = _stacked(6, seed=1)
    weights = np.array([0.2, 0.1, 0.1, 0.3, 0.0, 0.0], np.float32)
    sw = 0.3
    want = ref_aggregate_stacked(
        {k: jnp.asarray(v) for k, v in glob.items()},
        {k: jnp.asarray(v) for k, v in stacked.items()},
        jnp.asarray(weights),
        sw,
    )
    got = aggregate_stacked(
        {k: torch.from_numpy(v) for k, v in glob.items()},
        {k: torch.from_numpy(v) for k, v in stacked.items()},
        weights,
        sw,
    )
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=2e-5, atol=2e-5)


def test_padded_zero_weight_slots_add_nothing():
    glob, stacked = _stacked(4, seed=2)
    weights = np.array([0.25, 0.25, 0.5, 0.0], np.float32)
    as_t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    full = aggregate_stacked(as_t(glob), as_t(stacked), weights, 0.0)
    live = aggregate_stacked(as_t(glob), {k: v[:3] for k, v in as_t(stacked).items()}, weights[:3], 0.0)
    for k in full:
        np.testing.assert_array_equal(full[k].numpy(), live[k].numpy())


def test_wrapper_rejects_bad_input():
    U = torch.zeros(3, 8)
    with pytest.raises(ValueError):
        aggregate_flat(U, torch.zeros(2))
    with pytest.raises(TypeError):
        aggregate_flat(U.double(), torch.zeros(3, dtype=torch.float64))
    with pytest.raises(ValueError, match="unsupported devices"):
        aggregate_flat(U.to("meta"), torch.zeros(3))
    # meta inputs (the dry-run's) give the output's shape and no data
    out = aggregate_flat(U.to("meta"), torch.zeros(3, device="meta"))
    assert out.device.type == "meta" and out.shape == (8,) and out.dtype == torch.float32


def _columns_of_grid(p, blocks, threads, aligned):
    """How many times each of p columns is owned under csrc/aggregate.cu's
    index map: aligned, thread j = b·T + t < p / 2 owns columns 2j and
    2j + 1; otherwise thread t of block b owns c0 = 2·T·b + t (if c0 < p)
    and c0 + T (if < p)."""
    owned = np.zeros(p, np.int64)
    b, t = np.meshgrid(np.arange(blocks), np.arange(threads), indexing="ij")
    if aligned:
        j = (b * threads + t).ravel()
        j = j[j < p // ops.VEC]
        for c in range(ops.VEC):
            np.add.at(owned, ops.VEC * j + c, 1)
    else:
        c0 = (ops.VEC * threads * b + t).ravel()
        c0 = c0[c0 < p]
        for c in range(ops.VEC):
            cols = c0 + c * threads
            np.add.at(owned, cols[cols < p], 1)
    return owned


@pytest.mark.parametrize("p", [1, 2, 3, 64, 1001, 4099, 39759, 39760, 39761, 100_003, 2_000_000])
def test_launch_plan_covers_every_column_once(p):
    blocks, threads = launch_plan(11, p)
    for aligned in ([False] if p % ops.VEC else [True, False]):
        np.testing.assert_array_equal(_columns_of_grid(p, blocks, threads, aligned), 1)


@pytest.mark.parametrize("p", [1, 64, 39759, 39760, 2_000_000])
def test_launch_plan_is_one_block_an_sm_and_depends_on_the_shape_only(p):
    plans = {launch_plan(k, p) for k in (1, 11, 41, 300)}
    assert len(plans) == 1  # the kernel walks k in passes: k never changes the grid
    blocks, threads = plans.pop()
    groups = -(-p // ops.VEC)
    assert 32 <= threads <= ops.MAX_THREADS
    assert (blocks - 1) * threads < groups <= blocks * threads  # no block without a column
    if groups <= ops.SMS * ops.MAX_THREADS:
        assert blocks <= ops.SMS  # no second wave on a 132-SM card
    else:
        assert threads == ops.MAX_THREADS
    assert launch_plan(11, 39760) == (132, 151)  # the main path's grid


# ---------------------------------------------------------------------------
# trees: weighted_tree_sum and aggregate_trees
# ---------------------------------------------------------------------------
def _trees(k, seed, nested=False):
    """k parameter trees of one structure (the MLP's dict, or a nested one
    with a list and a bf16 leaf) and their (k,) weights, as numpy."""
    rng = np.random.default_rng(seed)
    shapes = {"w0": (16, 8), "b0": (8,), "w1": (8, 10), "b1": (10,)}
    trees = [{key: rng.normal(size=s).astype(np.float32) for key, s in shapes.items()}
             for _ in range(k)]
    if nested:
        trees = [{"blocks": [{"w": t["w0"], "b": t["b0"]}, {"w": t["w1"]}], "head": t["b1"],
                  "emb": rng.normal(size=(5, 4)).astype(np.float32)} for t in trees]
    return trees, rng.dirichlet(np.ones(k)).astype(np.float32)


def _tree_to(tree, fn):
    if isinstance(tree, dict):
        return {key: _tree_to(v, fn) for key, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, fn) for v in tree]
    return fn(tree)


def _leaves(tree):
    import jax

    return jax.tree_util.tree_leaves(tree)


@pytest.mark.parametrize("nested", [False, True], ids=["mlp", "nested"])
@pytest.mark.parametrize("k", [1, 5])
def test_aggregate_trees_matches_reference(k, nested):
    """The port's one-launch tree sum against the reference's
    ``aggregate_trees(..., interpret=True)``, leaf for leaf in
    ``jax.tree_util`` order, within f32 rounding (rtol = atol 2e-5, the
    aggregate kernel's limit); the structure and each leaf's shape and
    dtype kept."""
    from repro.kernels.aggregate.ops import aggregate_trees as ref_aggregate_trees

    trees, w = _trees(k, seed=3, nested=nested)
    want = ref_aggregate_trees(_tree_to(trees, jnp.asarray), w, interpret=True)
    got = ops.aggregate_trees(_tree_to(trees, torch.from_numpy), w)
    assert list(got) == list(trees[0])  # the caller's key order
    for a, b in zip(_leaves(_tree_to(got, lambda t: t.numpy())), _leaves(want)):
        assert a.shape == b.shape and a.dtype == np.float32
        np.testing.assert_allclose(a, np.asarray(b), rtol=2e-5, atol=2e-5)


def test_aggregate_trees_keeps_each_leafs_dtype_and_is_one_call(monkeypatch):
    """A bf16 leaf comes back bf16, and a call is one ``aggregate_flat``
    call over the (k, p) rows (one kernel launch on the card)."""
    calls = []
    real = ops.aggregate_flat

    def spy(U, w):
        calls.append(tuple(U.shape))
        return real(U, w)

    monkeypatch.setattr(ops, "aggregate_flat", spy)
    trees, w = _trees(3, seed=4)
    trees = [{**_tree_to(t, torch.from_numpy), "h": torch.ones(6, dtype=torch.bfloat16)} for t in trees]
    got = ops.aggregate_trees(trees, torch.from_numpy(w))
    assert calls == [(3, 16 * 8 + 8 + 8 * 10 + 10 + 6)]
    assert got["h"].dtype == torch.bfloat16
    np.testing.assert_allclose(got["h"].float().numpy(), np.full(6, w.sum()), rtol=2e-3)
    with pytest.raises(ValueError, match="2 trees vs 3 weights"):
        ops.aggregate_trees(trees[:2], w)


@pytest.mark.parametrize("k", [1, 4])
def test_weighted_tree_sum_matches_reference(k):
    from repro.fl.aggregation import weighted_tree_sum as ref_weighted_tree_sum
    from repro_torch.fl.aggregation import weighted_tree_sum

    trees, w = _trees(k, seed=5)
    want = ref_weighted_tree_sum(_tree_to(trees, jnp.asarray), w.astype(np.float64))
    got = weighted_tree_sum(_tree_to(trees, torch.from_numpy), w.astype(np.float64))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("stale", [0.0, 0.25])
def test_aggregate_round_matches_reference_through_the_tree_sum(stale):
    """``aggregate_round`` is ``weighted_tree_sum`` over the clients and
    θ^t (carrying ``stale_weight``): equal to the reference's within f32
    rounding, and bit-equal to ``aggregate_stacked`` over the same rows."""
    from repro.fl.aggregation import aggregate_round as ref_aggregate_round
    from repro_torch.fl.aggregation import aggregate_round

    trees, w = _trees(4, seed=6)
    w = w * (1 - stale)
    glob = _trees(1, seed=7)[0][0]
    want = ref_aggregate_round(_tree_to(glob, jnp.asarray), _tree_to(trees, jnp.asarray), w, stale)
    as_t = lambda t: _tree_to(t, torch.from_numpy)
    got = aggregate_round(as_t(glob), [as_t(t) for t in trees], w, stale)
    stacked = aggregate_stacked(as_t(glob), {key: torch.stack([as_t(t)[key] for t in trees])
                                             for key in glob}, w, stale)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=2e-5, atol=2e-5)
        assert torch.equal(got[key], stacked[key])
