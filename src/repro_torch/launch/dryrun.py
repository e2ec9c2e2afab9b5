"""Dry-run: every (arch × shape × mesh) step of the port, counted on meta positions.

Port of ``src/repro/launch/dryrun.py``. The reference lowers and compiles
each step with XLA on 256 or 512 placeholder host devices and reads
``memory_analysis()``, ``cost_analysis()`` and the HLO's collectives. Eager
PyTorch has no compiler, so the port's counterpart runs its own step on
meta tensors (no data, no memory) on the production mesh of meta positions
(``launch.mesh.make_production_mesh``) under the placements of
:func:`build_shardings`, and counts it by mesh position with
``launch.roofline.CostCounter``:

* the train step is ``make_train_step(cfg, opt, mesh=mesh)``: each data
  group gathers the whole model onto its first position and computes its
  rows there, and every position updates its own blocks (ROADMAP lever
  L8), so positions are not uniform;
* prefill and decode run the same way (:func:`_sharded_infer_step`): each
  data group gathers the model, its rows of the batch (and of the decode
  caches) onto its first position and runs the one-device step on them,
  then sends each output row to the positions its placement puts it on.

Per-chip figures of a record are the largest position's, each figure on
its own; the per-position lists are under ``per_position``. Memory is
``memory_analysis()``'s counterpart: arguments and outputs from the
placements (``sharding.placement_bytes``), temp the peak of the live bytes
the step allocated at each position.

Counts are taken at full depth, in one run, never extrapolated over
repeats. The one shortcut is the sLSTM's loop over time: a step's work does
not depend on t, so a model with an sLSTM block is counted twice with the
loop cut to 2 and to 3 steps on meta (``xlstm.counted_loop_steps``) and
the counts extrapolated linearly to the sequence's S steps, which gives
the counts of a full-S run exactly (``tests/test_torch_dryrun.py``); the
peak of live bytes is extrapolated the same way, which is an estimate.
With ``lower_only`` only the placements are computed (arguments and
outputs by position) and no step runs.

Records go to ``experiments/dryrun_torch`` (not the reference's
``experiments/dryrun``): H100 counts never mix with TPU ones.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  python -m repro_torch.launch.dryrun --all                    # 40 baselines
  python -m repro_torch.launch.dryrun --all --multi-pod --lower-only
  python -m repro_torch.launch.dryrun ... --variant fused_ce --variant absorbed_mla
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.kernels import _build
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import (
    Mesh,
    Placement,
    data_group_positions,
    make_production_mesh,
    mesh_chips,
    on_shard,
)
from repro_torch.launch.sharding import (
    Placed,
    batch_shardings,
    block_index,
    cache_shardings,
    opt_state_shardings,
    param_shardings,
    place,
    placement_bytes,
    replicated,
)
from repro_torch.launch.steps import (
    abstract_params,
    abstract_train_state,
    data_degree,
    default_optimizer,
    input_specs,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)
from repro_torch.models import model as mdl
from repro_torch.models.config import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.models.layers import xlstm
from repro_torch.optim.base import Optimizer

OUT_DIR = "experiments/dryrun_torch"

VARIANTS = (
    "fused_ce",
    "absorbed_mla",
    "block_attn",
    "expert_parallel",
    "no_remat",
    "mlstm_chunk",
    "sp_residual",
)


def apply_variants(cfg, variants: list[str]):
    if "fused_ce" in variants:
        cfg = dataclasses.replace(cfg, fused_ce=True)
    if "absorbed_mla" in variants and cfg.mla is not None:
        cfg = dataclasses.replace(cfg, mla=dataclasses.replace(cfg.mla, decode_mode="absorbed"))
    if "block_attn" in variants:
        cfg = dataclasses.replace(cfg, attn_block_q=512)
    if "no_remat" in variants:
        cfg = dataclasses.replace(cfg, remat=False)
    if "mlstm_chunk" in variants:
        cfg = dataclasses.replace(cfg, mlstm_chunk=2048)
    if "sp_residual" in variants:
        cfg = dataclasses.replace(cfg, seq_parallel_residual=True)
    return cfg


def build_shardings(cfg: ModelConfig, shape: InputShape, mesh: Mesh, step_kind: str,
                    opt: Optimizer, *, expert_parallel: bool = False):
    """``(in placements, out placements, (state or params, input specs))``
    of the train, prefill or decode step, as the reference's
    ``build_shardings``: the state, batch and metrics of a train step; the
    parameters, inputs, last logits and caches of a prefill or decode."""
    specs = input_specs(cfg, shape)
    if step_kind == "train":
        state_shape = abstract_train_state(cfg, opt)
        p_sh = param_shardings(mesh, state_shape["params"], expert_parallel=expert_parallel)
        state_sh = {
            "params": p_sh,
            "opt_state": opt_state_shardings(mesh, state_shape["opt_state"], p_sh),
            "step": replicated(mesh, state_shape["step"]),
        }
        metrics_sh = {k: Placement(mesh, ()) for k in ("loss", "grad_norm", "ce", "aux")}
        return (state_sh, batch_shardings(mesh, specs)), (state_sh, metrics_sh), (state_shape, specs)

    params_shape = abstract_params(cfg)
    p_sh = param_shardings(mesh, params_shape, expert_parallel=expert_parallel)
    batch_sh = {k: cache_shardings(mesh, v, cfg) if k == "caches" else batch_shardings(mesh, v)
                for k, v in specs.items()}
    b = shape.global_batch
    logits_sh = batch_shardings(mesh, _logits_like(cfg, b))
    if step_kind == "prefill":
        caches = mdl.init_cache(cfg, b, shape.seq_len, device="meta")
        out_sh = (logits_sh, cache_shardings(mesh, caches, cfg))
    else:
        out_sh = (logits_sh, batch_sh["caches"])
    return (p_sh, batch_sh), out_sh, (params_shape, specs)


def mesh_name(mesh: Mesh) -> str:
    """The mesh's shape as the records name it: "16x16", "2x16x16"."""
    return "x".join(str(n) for n in mesh.devices.shape)


def _logits_like(cfg: ModelConfig, batch: int) -> torch.Tensor:
    return torch.empty((batch, cfg.vocab_size), dtype=getattr(torch, cfg.dtype), device="meta")


def _with_repeats(cfg, n: int):
    """A structurally-identical config with ``n`` pattern repeats (and a
    matching encoder depth for enc-dec archs)."""
    n_layers = len(cfg.first_blocks) + len(cfg.pattern) * n + len(cfg.tail_blocks)
    enc = cfg.encoder
    if enc is not None:
        enc = dataclasses.replace(enc, n_layers=n)
    return dataclasses.replace(cfg, n_layers=n_layers, encoder=enc, scan_layers=False)


# --------------------------------------------------------------------------
# prefill and decode over a mesh
# --------------------------------------------------------------------------
def _rows(tree, lo: int, hi: int, dev):
    """A step input's rows ``lo:hi`` on ``dev`` at the running position:
    each placed leaf's blocks that hold them copied there (that position's
    own first); other leaves (a cache's position) as they are."""
    if isinstance(tree, dict):
        return {k: _rows(v, lo, hi, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rows(v, lo, hi, dev) for v in tree)
    if not isinstance(tree, Placed):
        return tree
    here = _build.current_shard() or 0
    out = torch.empty((hi - lo,) + tree.shape[1:], dtype=tree.dtype, device=dev)
    done = set()
    for pos in sorted(range(len(tree.blocks)), key=lambda p: p != here):
        idx = tree.index(pos)
        r0, r1 = max(idx[0].start, lo), min(idx[0].stop, hi)
        key = (r0, r1) + tuple((sl.start, sl.stop) for sl in idx[1:])
        if r0 >= r1 or key in done:
            continue
        done.add(key)
        dst = out[(slice(r0 - lo, r1 - lo),) + idx[1:]]
        dst.copy_(tree.blocks[pos][r0 - idx[0].start:r1 - idx[0].start])
        _build.count_moved("all-gather", pos, here, dst.numel() * dst.element_size())
    return out


def _send_rows(out, placements, batch: int, lo: int, hi: int, src: int) -> None:
    """Count the copies that put an output's rows ``lo:hi`` of ``batch``
    (held at position ``src``) where ``placements`` put them: each
    position gets the part of its block inside those rows."""
    if isinstance(out, dict):
        for k, v in out.items():
            _send_rows(v, placements[k], batch, lo, hi, src)
    elif isinstance(out, (list, tuple)):
        for v, pl in zip(out, placements):
            _send_rows(v, pl, batch, lo, hi, src)
    elif isinstance(out, torch.Tensor) and out.dim():
        whole = (batch,) + tuple(out.shape[1:])
        for pos in range(placements.mesh.devices.size):
            idx = block_index(placements, whole, pos)
            n = max(0, min(idx[0].stop, hi) - max(idx[0].start, lo)) * out.element_size()
            for sl in idx[1:]:
                n *= sl.stop - sl.start
            _build.count_moved("collective-permute", src, pos, n)


def _sharded_infer_step(cfg: ModelConfig, shape: InputShape, mesh: Mesh, kind: str, out_sh):
    """The prefill (or decode) step over ``mesh``'s placements, as
    ``make_train_step(mesh=)`` runs a train step: each of the
    :func:`~repro_torch.launch.steps.data_degree` groups gathers the whole
    model and its rows of the inputs onto its first position and runs the
    one-device step there; the outputs' rows are counted as sent where
    ``out_sh`` places them. Returns each group's outputs."""
    like = abstract_params(cfg)
    named = dict(like.named_parameters())
    runs = [(n, off, named[n].shape, named[n].numel()) for n, off in mdl.flat_runs(like)]
    total = sum(p.numel() for p in named.values())
    firsts = [g[0] for g in data_group_positions(mesh)]
    b = shape.global_batch
    seq = shape.seq_len if kind == "prefill" else 1

    def step(params, batch):
        d = data_degree(cfg, mesh, b, seq)
        outs = []
        for k in range(d):
            pos = firsts[k * len(firsts) // d]
            dev = mesh.devices.flat[pos]
            lo, hi = k * b // d, (k + 1) * b // d
            part = InputShape(shape.name, shape.seq_len, hi - lo, shape.kind)
            one = make_prefill_step(cfg, part) if kind == "prefill" else make_serve_step(cfg, part)
            with on_shard(pos, dev):
                flat = torch.empty(total, dtype=params["embed"].dtype, device=dev)
                for n, off, shp, numel in runs:
                    params[n].gather(dev, out=flat[off:off + numel].view(shp))
                out = one(mdl.lm_views(flat, like), _rows(batch, lo, hi, dev))
                del flat
            _send_rows(out, out_sh, b, lo, hi, pos)
            outs.append(out)
        return outs

    return step


# --------------------------------------------------------------------------
# counting
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Counted:
    """The port's ``Compiled``: a step's kind and abstract state, its
    arguments' and outputs' bytes by position from the placements, and its
    counts (``CostCounter.summary``; None when only placed)."""

    kind: str
    state_shape: object
    args: list
    outs: list
    counts: Optional[dict]

    @property
    def temp(self) -> list:
        """Each position's peak of live intermediates: the peak of what the
        step allocated less what it returns."""
        if self.counts is None:
            return [0] * len(self.args)
        return [a - b for a, b in zip(self.counts["peak"], self.counts["end"])]


def _sum(*lists) -> list:
    return [sum(x) for x in zip(*lists)]


def count_step(step, args: tuple, positions: int, cfg: ModelConfig, seq_len: int,
               kind: str) -> dict:
    """``step(*args)`` on meta inputs under a
    :class:`~repro_torch.launch.roofline.CostCounter` over ``positions``
    positions: its summary. A model with an sLSTM block (prefill or train)
    is counted with the loop cut to 2 and 3 steps and extrapolated to
    ``seq_len`` (see the module docstring)."""

    def once():
        with rl.CostCounter(positions, placed=args) as counter:
            out = step(*args)  # held until the count ends: its bytes are the step's outputs
        del out
        return counter.summary()

    if kind == "decode" or seq_len <= 3 or all(m != "slstm" for m, _ in cfg.all_blocks):
        return once()
    with xlstm.counted_loop_steps(2):
        two = once()
    with xlstm.counted_loop_steps(3):
        three = once()
    return rl.extrapolate(two, three, seq_len - 2)


def _compile(cfg, shape, mesh, *, expert_parallel: bool, lower_only: bool = False) -> Counted:
    """The step of ``cfg`` at ``shape`` over ``mesh`` with every input a
    meta tensor placed by :func:`build_shardings`, run under the counter
    (not run with ``lower_only``)."""
    opt = default_optimizer()
    kind = shape.kind
    in_sh, out_sh, (state_shape, specs) = build_shardings(
        cfg, shape, mesh, kind, opt, expert_parallel=expert_parallel)
    args = _sum(placement_bytes(in_sh[0], state_shape), placement_bytes(in_sh[1], specs))
    if kind == "train":
        metrics = {k: torch.empty((), device="meta") for k in out_sh[1]}
        outs = _sum(placement_bytes(out_sh[0], state_shape), placement_bytes(out_sh[1], metrics))
    else:
        caches = (mdl.init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
                  if kind == "prefill" else specs["caches"])
        outs = _sum(placement_bytes(out_sh[0], _logits_like(cfg, shape.global_batch)),
                    placement_bytes(out_sh[1], caches))
    if lower_only:
        return Counted(kind, state_shape, args, outs, None)
    state, batch = place(state_shape, in_sh[0]), place(specs, in_sh[1])
    if kind == "train":
        step = make_train_step(cfg, opt, mesh=mesh)
    else:
        step = _sharded_infer_step(cfg, shape, mesh, kind, out_sh)
    counts = count_step(step, (state, batch), mesh.devices.size, cfg, shape.seq_len, kind)
    return Counted(kind, state_shape, args, outs, counts)


def _costs(compiled: Counted) -> dict:
    """The per-chip costs: the largest position's FLOPs, bytes and moved
    bytes, and the moves by kind at the position that moves the most."""
    c = compiled.counts
    if c is None:
        return {"flops": 0.0, "bytes": 0.0, "coll_bytes": 0.0,
                "colls": {k: {"count": 0, "bytes": 0.0} for k in rl.COLLECTIVES}}
    busiest = max(range(len(c["moved"])), key=c["moved"].__getitem__)
    return {
        "flops": float(max(c["flops"])),
        "bytes": float(max(c["bytes"])),
        "coll_bytes": float(max(c["moved"])),
        "colls": {k: {"count": int(v["count"][busiest]), "bytes": float(v["bytes"][busiest])}
                  for k, v in c["colls"].items()},
    }


def run_one(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool,
    variants: list[str],
    out_dir: str,
    lower_only: bool = False,
):
    """Count ``arch`` at ``shape_name`` on the production mesh and write
    its record, as the
    reference's ``run_one``: the Roofline's fields, the parameter counts,
    ``kind``, ``lower_only``, ``compile_s`` (the seconds the placements
    and the counted run took), ``hbm_per_chip_gb`` (the largest position's
    arguments, temp and outputs), and ``per_position``."""
    t0 = time.time()
    shape = INPUT_SHAPES[shape_name]
    cfg = apply_variants(get_config(arch), variants)
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh_chips(mesh)
    compiled = _compile(cfg, shape, mesh, expert_parallel="expert_parallel" in variants,
                        lower_only=lower_only)
    kind = compiled.kind
    cost = _costs(compiled)
    params_shape = compiled.state_shape["params"] if kind == "train" else compiled.state_shape
    n_total, n_active = rl.active_params(params_shape, cfg)
    tokens = shape.tokens if kind != "decode" else shape.global_batch  # 1 new token each
    mf = rl.model_flops(n_active, tokens, kind)
    hbm = _sum(compiled.args, compiled.temp, compiled.outs)

    roof = rl.Roofline(
        arch=arch,
        shape=shape_name,
        mesh=mesh_name(mesh),
        chips=chips,
        flops_per_chip=cost["flops"],
        bytes_per_chip=cost["bytes"],
        coll_bytes_per_chip=cost["coll_bytes"],
        coll_detail=cost["colls"],
        model_flops_global=mf,
        arg_bytes_per_chip=float(max(compiled.args)),
        temp_bytes_per_chip=float(max(compiled.temp)),
        out_bytes_per_chip=float(max(compiled.outs)),
    )
    rec = roof.to_dict()
    per = {"args": compiled.args, "temp": compiled.temp, "outs": compiled.outs}
    if compiled.counts is not None:
        per.update({k: compiled.counts[k] for k in ("flops", "bytes", "moved", "kernels")})
    rec.update(
        n_params=n_total,
        n_params_active=n_active,
        variants=variants,
        kind=kind,
        lower_only=lower_only,
        compile_s=round(time.time() - t0, 1),
        hbm_per_chip_gb=round(max(hbm) / 2**30, 3),
        per_position=per,
    )
    os.makedirs(out_dir, exist_ok=True)
    tag = "+".join(variants) if variants else "baseline"
    fname = f"{arch}__{shape_name}__{rec['mesh']}__{tag}.json"
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(rec, f, indent=1)

    print(
        f"[OK] {arch:22s} {shape_name:12s} mesh={rec['mesh']:8s} {tag:14s} "
        f"args={roof.arg_bytes_per_chip/2**30:6.2f}GiB temp={roof.temp_bytes_per_chip/2**30:7.2f}GiB "
        f"flops/chip={rec['flops_per_chip']:.3e} coll/chip={roof.coll_bytes_per_chip/2**20:9.1f}MiB "
        f"tc={roof.t_compute*1e3:8.2f}ms tm={roof.t_memory*1e3:8.2f}ms "
        f"tx={roof.t_collective*1e3:8.2f}ms dom={roof.dominant:10s} "
        f"util={roof.utility_ratio:5.2f} ({rec['compile_s']}s)",
        flush=True,
    )
    return rec


def main(argv: "list[str] | None" = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=tuple(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true", help="all (arch × shape) baselines")
    ap.add_argument("--variant", action="append", default=[], choices=VARIANTS)
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument(
        "--lower-only",
        action="store_true",
        help="the placements only, no counted run (the multi-pod pass)",
    )
    args = ap.parse_args(argv)

    combos = (
        [(a, s) for a in ARCH_NAMES for s in INPUT_SHAPES]
        if args.all
        else [(args.arch, args.shape)]
    )
    failures = []
    for arch, shape in combos:
        try:
            run_one(
                arch,
                shape,
                multi_pod=args.multi_pod,
                variants=args.variant,
                out_dir=args.out,
                lower_only=args.lower_only,
            )
        except Exception as e:  # noqa: BLE001 - report and continue the matrix
            failures.append((arch, shape, repr(e)))
            print(f"[FAIL] {arch} {shape}: {e}", flush=True)
            traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures: {failures}")
    print("dry-run complete: all combinations placed" + ("." if args.lower_only else " and counted."))


if __name__ == "__main__":
    main()
