"""The dryrun phase's checks of ``chip_smoke.py``, held against wrong counts on the CPU.

A kernel's calls in a counted step must equal its wrapper's own launches
in that step (and the launches tallied by mesh position over a mesh): the
check accepts equal counts and rejects a step that ran a plain version
(calls, no launch), launched by another position, or launched a kernel
the counter never saw. The per-op bound adds a copy between two positions
of one card to that card's HBM bytes (read and written) and prices a copy
between cards over NVLink. The least-work bound reads each argument's
storage once and writes each output's storage once, and prices the step's
counted FLOPs; on a reduced train step over a 2 × 2 mesh of CPU shards it
reads the distinct blocks the placements hold.
"""
import collections
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.launch import dryrun, roofline as rl, sharding, steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as mdl
from repro_torch.models.config import InputShape
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


def _cards(*indices):
    """A stand-in mesh whose positions sit on the given card indices."""
    return SimpleNamespace(devices=np.array([torch.device("cuda", i) for i in indices], dtype=object))


def _card(calls: dict, n: int = 1) -> dict:
    return {"flops": [0] * n, "kernels": {k: {"calls": v} for k, v in calls.items()}}


@pytest.mark.parametrize("calls,launched,tallied,ok", [
    ({"flash_attention": [56]}, {"flash_attention": 56}, None, True),
    ({"flash_attention": [56]}, {"flash_attention": 0}, None, False),  # the plain version ran
    ({"flash_attention": [56]}, {"flash_attention": 55}, None, False),
    ({}, {"aggregate": 1}, None, False),  # a launch the counter never saw
    ({"flash_attention": [3, 0, 3, 0]}, {"flash_attention": 6}, [3, 0, 3, 0], True),
    ({"flash_attention": [3, 0, 3, 0]}, {"flash_attention": 6}, [3, 3, 0, 0], False),
    ({"aggregate": [1, 1, 1, 1]}, {"aggregate": 4}, [1, 1, 1, 1], True),
    ({"aggregate": [1, 1, 1, 1]}, {"aggregate": 3}, [1, 1, 0, 1], False),
])
def test_calls_must_equal_the_wrappers_launches(monkeypatch, calls, launched, tallied, ok):
    n = 1 if tallied is None else len(tallied)
    shard = {(k, p): v for k in calls or launched for p, v in enumerate(tallied or [])}
    monkeypatch.setattr(_build, "shard_launches", collections.Counter(shard))
    launched = {**dict.fromkeys(("flash_attention", "aggregate", "gram", "l1", "srp"), 0), **launched}
    mesh = None if tallied is None else _cards(*range(n))
    if ok:
        smoke._launches_against_calls("t", _card(calls, n), mesh, launched)
    else:
        with pytest.raises(RuntimeError, match="against launches"):
            smoke._launches_against_calls("t", _card(calls, n), mesh, launched)


@pytest.mark.parametrize("mesh,memory_ms,collective_ms", [
    # two positions on one card: the copy is read and written in its HBM
    (_cards(0, 0), (10e9 + 2 * 3e9) / rl.HBM_BW * 1e3, 0.0),
    # on two cards: over NVLink, the first card's own bytes alone
    (_cards(0, 1), 6e9 / rl.HBM_BW * 1e3, 3e9 / rl.LINK_BW * 1e3),
])
def test_per_op_bound_prices_copies_by_card(mesh, memory_ms, collective_ms):
    counts = {"flops": [1e12, 0], "bytes": [6e9, 4e9], "pairs": [[0, 1, 3e9]]}
    ms, term = smoke._card_bound(counts, mesh)
    want = {"compute": 1e12 / rl.PEAK_FLOPS * 1e3, "memory": memory_ms, "collective": collective_ms}
    assert term == max(want, key=want.get) and ms == pytest.approx(want[term], rel=1e-12)


def test_least_bound_reads_each_storage_once():
    a = torch.zeros(1000)
    args = ({"x": a, "again": a, "view": a[10:20]}, [torch.zeros(24)])
    out = {"y": torch.zeros(500), "x": a}  # written in place: written once more
    ms, term = smoke._least_bound({"flops": [0], "pairs": []}, None, args, out)
    assert term == "memory"
    assert ms == pytest.approx((4000 + 96 + 2000 + 4000) / rl.HBM_BW * 1e3, rel=1e-12)
    ms, term = smoke._least_bound({"flops": [rl.PEAK_FLOPS], "pairs": []}, None, args, out)
    assert (term, ms) == ("compute", pytest.approx(1e3, rel=1e-12))


def test_least_bound_of_a_sharded_train_step_reads_the_placed_blocks():
    cfg = get_config("qwen3-0.6b", reduced=True)
    shape = InputShape("small", 16, 4, "train")
    opt = steps.default_optimizer()
    mesh = make_host_mesh(2, 2, device="cpu")
    (state_sh, batch_sh), _, _ = dryrun.build_shardings(cfg, shape, mesh, "train", opt)
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (4, 16), generator=gen)
    state = sharding.place(steps.init_train_state(mdl.init_params(cfg, 0, device="cpu"), opt),
                           state_sh)
    batch = sharding.place({"tokens": tokens, "targets": tokens.clone()}, batch_sh)
    with rl.CostCounter(4, placed=(state, batch)) as c:
        out = steps.make_train_step(cfg, opt, mesh=mesh)(state, batch)
    counts = c.summary()
    ms, term = smoke._least_bound(counts, mesh, (state, batch), out)
    # every CPU shard is card 0; the blocks that positions share count once
    blocks = {}
    for leaf in sharding.leaves((state, batch)):
        for b in leaf.blocks:
            st = b.untyped_storage()
            blocks[st.data_ptr()] = st.nbytes()
    assert smoke._storage_bytes((state, batch), {}) == {0: sum(blocks.values())}
    assert ms >= sum(counts["flops"]) / rl.PEAK_FLOPS * 1e3
    assert ms >= sum(blocks.values()) / rl.HBM_BW * 1e3
    assert term in ("compute", "memory")
    assert ms < smoke._card_bound(counts, mesh)[0]
