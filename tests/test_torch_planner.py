"""The port's PlanService with an injected drift monitor, and the samplers'
``representative_gradients``, against the JAX reference.

The plans and snapshots of the reference's ``tests/test_planner.py`` drive
both packages: twenty rows in two clusters, a plan that labels them, and
snapshots that move rows from one cluster to the other (drift = moved / 20,
exact in both). Every number compared is equal, not close, except the
sketched store's rows: the port's SRP plain version and the reference's
kernel sum X·S in other orders, so they agree to rtol 1e-5 (B3's limit).
"""
import numpy as np
import pytest
import torch

from repro.core.types import SamplingPlan as RefSamplingPlan
from repro.fl.planner import AssignmentDriftMonitor as RefMonitor
from repro.fl.planner import PlanService as RefPlanService
from repro_torch.core.types import SamplingPlan
from repro_torch.fl.planner import AssignmentDriftMonitor, PlanService
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

LABELS = np.array([0] * 10 + [1] * 10)


def two_cluster_G(flip: int = 0) -> np.ndarray:
    """The reference test's snapshot: 20 rows in two separated clusters, the
    first ``flip`` rows of cluster 0 moved onto cluster 1's center."""
    G = np.zeros((20, 4), np.float32)
    G[:10, 0] = 5.0
    G[10:, 1] = 5.0
    if flip:
        G[:flip, 0] = 0.0
        G[:flip, 1] = 5.0
    return G


def _services(mode: str, **kw):
    """(port, reference) services over the labelled plan, each with the
    monitor ``kw`` injects (built per package)."""
    port_kw = {k: v() if callable(v) else v for k, v in kw.items()}
    ref_kw = {k: (RefMonitor() if callable(v) else v) for k, v in kw.items()}
    port = PlanService(lambda G: SamplingPlan(r=np.full((4, 20), 0.05), cluster_of=LABELS),
                       mode=mode, initial_input=torch.from_numpy(two_cluster_G()), **port_kw)
    ref = RefPlanService(lambda G: RefSamplingPlan(r=np.full((4, 20), 0.05), cluster_of=LABELS),
                         mode=mode, initial_input=two_cluster_G(), **ref_kw)
    return port, ref


def _observe(svc, G, is_port):
    svc.observe(torch.from_numpy(G) if is_port else G)
    svc.flush()
    vp = svc.poll()
    return (None if vp is None else vp.version, svc.last_drift(), svc.rebuilds_done(),
            svc.telemetry())


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_injected_monitor_drives_the_trigger_as_the_reference(mode):
    """``drift_monitor=`` with ``drift_threshold``: the injected monitor is
    the one the trigger reads and re-baselines, observation by observation
    as the reference's ``test_drift_trigger_fires_iff_threshold_crossed``
    drives it."""
    monitor = AssignmentDriftMonitor()
    port, ref = _services(mode, drift_threshold=0.25, drift_monitor=lambda: monitor)
    try:
        assert port._monitor is monitor
        assert monitor.drift(torch.from_numpy(two_cluster_G())) == 0.0  # baselined at version 0
        for flip in (2, 5, 5, 10, 0):
            got = _observe(port, two_cluster_G(flip), True)
            want = _observe(ref, two_cluster_G(flip), False)
            assert got == want, flip
        assert monitor.drift(torch.from_numpy(two_cluster_G())) == ref._monitor.drift(two_cluster_G())
    finally:
        port.close()
        ref.close()


def test_injected_monitor_without_threshold_is_only_rebaselined():
    """Without ``drift_threshold`` an injected monitor decides nothing (the
    cadence does), and each build re-baselines it, as in the reference."""
    monitor = AssignmentDriftMonitor()
    port, ref = _services("sync", drift_monitor=lambda: monitor)
    try:
        for flip in (2, 5):
            assert _observe(port, two_cluster_G(flip), True) == _observe(ref, two_cluster_G(flip), False)
            assert monitor.drift(torch.from_numpy(two_cluster_G(flip))) == 0.0
            assert ref._monitor.drift(two_cluster_G(flip)) == 0.0
    finally:
        port.close()
        ref.close()


def test_default_monitor_and_none():
    """No injected monitor: a fresh one with a threshold, none without."""
    port, ref = _services("sync", drift_threshold=0.1)
    assert isinstance(port._monitor, AssignmentDriftMonitor) and isinstance(ref._monitor, RefMonitor)
    plain, ref_plain = _services("sync")
    assert plain._monitor is None and ref_plain._monitor is None
    for svc in (port, ref, plain, ref_plain):
        svc.close()


@pytest.mark.parametrize("sketch", [None, "srp"])
def test_representative_gradients_equal_reference(sketch):
    """``representative_gradients`` is a host numpy copy of the resident G
    (sketch space when sketched), equal to the reference's after the same
    observations, and a copy: later scatters do not change it."""
    from repro.core.samplers import Algorithm2Sampler as RefAlgorithm2
    from repro.core.types import ClientPopulation as RefPopulation
    from repro_torch.core.samplers import Algorithm2Sampler
    from repro_torch.core.types import ClientPopulation

    sizes = np.array([30, 50, 20, 80, 40, 60, 10, 90])
    kw = dict(update_dim=48, seed=3, sketch=sketch, sketch_dim=8 if sketch else None)
    port = Algorithm2Sampler(ClientPopulation(sizes), 3, device="cpu", **kw)
    ref = RefAlgorithm2(RefPopulation(sizes), 3, distance_fn="numpy", **kw)
    try:
        ids = np.array([1, 4, 6])
        U = (1e-2 * np.random.default_rng(2).normal(size=(3, 48))).astype(np.float32)
        port.observe_updates(ids, torch.from_numpy(U))
        ref.observe_updates(ids, U)
        got = port.representative_gradients
        assert isinstance(got, np.ndarray) and got.shape == (8, 8 if sketch else 48)
        np.testing.assert_allclose(got, ref.representative_gradients, rtol=1e-5, atol=1e-7)
        if sketch is None:
            np.testing.assert_array_equal(got, ref.representative_gradients)
        port.observe_updates(ids, torch.from_numpy(2 * U))
        assert not np.array_equal(got, port.representative_gradients)
    finally:
        port.close()
        ref.close()
