"""The port's batched round step against the JAX reference's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl.engine import batched_round_step as ref_step
from repro.models import simple as ref_simple
from repro.optim import sgd as ref_sgd
from repro_torch.fl.engine import batched_round_step
from repro_torch.launch.mesh import Mesh
from repro_torch.models import simple
from repro_torch.optim.sgd import sgd
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

M_SLOTS, N_STEPS, BATCH, DIM, HIDDEN, N_CLIENTS, N_PAD = 10, 5, 8, 16, (8,), 12, 30


@pytest.mark.parametrize("mu,momentum", [(0.0, 0.0), (0.1, 0.0), (0.0, 0.9)])
def test_batched_round_step_matches_reference(mu, momentum):
    rng = np.random.default_rng(0)
    init = {k: np.asarray(v) for k, v in ref_simple.init_mlp((DIM, *HIDDEN, 10), seed=1).items()}
    x_all = rng.normal(size=(N_CLIENTS, N_PAD, DIM)).astype(np.float32)
    y_all = rng.integers(0, 10, size=(N_CLIENTS, N_PAD)).astype(np.int32)
    c = 7  # distinct clients; slots c.. are padding on client 0 with weight 0
    slot_ids = np.zeros(M_SLOTS, np.int32)
    slot_ids[:c] = rng.choice(N_CLIENTS, size=c, replace=False)
    idx = np.zeros((M_SLOTS, N_STEPS, BATCH), np.int32)
    idx[:c] = rng.integers(0, N_PAD, size=(c, N_STEPS, BATCH))
    w = np.zeros(M_SLOTS, np.float32)
    w[:c] = rng.dirichlet(np.ones(c)) * 0.8
    sw = 0.2
    lr = 0.1

    ref_loss = ref_simple.fedprox_loss if mu else ref_simple.classification_loss
    want_p, want_u, want_l = ref_step(
        {k: jnp.asarray(v) for k, v in init.items()},
        jnp.asarray(x_all),
        jnp.asarray(y_all),
        jnp.asarray(slot_ids),
        jnp.asarray(idx),
        jnp.asarray(w),
        jnp.asarray(sw, jnp.float32),
        loss_fn=ref_loss,
        opt=ref_sgd(lr, momentum),
        fedprox_mu=mu,
    )
    loss = simple.fedprox_loss if mu else simple.classification_loss
    got_p, got_u, got_l = batched_round_step(
        simple.params_from_numpy(init, device="cpu"),
        torch.from_numpy(x_all),
        torch.from_numpy(y_all).long(),
        torch.from_numpy(slot_ids).long(),
        torch.from_numpy(idx).long(),
        w,
        sw,
        loss_fn=loss,
        opt=sgd(lr, momentum),
        fedprox_mu=mu,
    )
    assert sorted(got_p) == sorted(want_p)
    for k in want_p:
        np.testing.assert_allclose(got_p[k].numpy(), np.asarray(want_p[k]), atol=1e-5)
    np.testing.assert_allclose(got_u.numpy(), np.asarray(want_u), atol=1e-5)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=1e-5)


def test_params_round_trip_numpy():
    init = {k: np.asarray(v) for k, v in ref_simple.init_mlp((DIM, 8, 10), seed=3).items()}
    back = simple.params_to_numpy(simple.params_from_numpy(init, device="cpu"))
    for k in init:
        np.testing.assert_array_equal(back[k], init[k])


def test_mlp_module_matches_apply_mlp():
    model = simple.MLP((DIM, 8, 10), generator=torch.Generator().manual_seed(0), device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(5, DIM)).astype(np.float32))
    np.testing.assert_array_equal(
        model(x).detach().numpy(), simple.apply_mlp(model.params(), x).detach().numpy()
    )
    p = simple.init_mlp((DIM, 8, 10), seed=0, device="cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "w0": (DIM, 8), "b0": (8,), "w1": (8, 10), "b1": (10,)
    }


def test_mesh_is_refused():
    """A round over a mesh whose lead device does not hold the global
    model is refused (the mesh itself is ported)."""
    on_card = Mesh(np.array([[torch.device("cuda", 0)]], dtype=object), ("data", "model"))
    with pytest.raises(ValueError, match="lead device"):
        batched_round_step({"w": torch.zeros(2)}, None, None, torch.zeros(1), None, None, 0.0,
                           loss_fn=None, opt=None, mesh=on_card)
