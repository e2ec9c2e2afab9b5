"""Synchronous LM trainer driver.

Port of ``src/repro/launch/train.py``. Usage:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
      --steps 10 --batch 4 --seq 1024
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \
      --steps 20 --batch 8 --seq 64

Parameters are random, from seed 0 (a ``torch.Generator``, not the
reference's ``jax.random``); batches come from the reference's synthetic
``TokenPipeline`` (seed 0), bit for bit, with the reference's zero
front-end stubs for whisper and qwen2-vl (``steps.frontend_stubs``).
``--checkpoint`` writes the train state under the reference's leaf keys
(:func:`~repro_torch.launch.steps.train_state_tree`), so
``repro.checkpoint.restore_checkpoint`` reads it.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.steps import (frontend_stubs, init_train_state, make_train_step,
                                      train_state_tree)
from repro_torch.models import model as mdl
from repro_torch.optim import adamw, linear_warmup_cosine


def train(cfg, *, steps: int, batch: int, seq: int, lr: float, device="cuda",
          log_every: int = 10, log=print) -> tuple[dict, list[dict]]:
    """Run ``steps`` train steps from seed-0 parameters; returns the final
    train state and one record a step: its ``loss``, ``ce``, ``grad_norm``
    and ``t``, the host clock when its loss reached the host."""
    dev = resolve_device(device)
    opt = adamw(linear_warmup_cosine(lr, steps // 10 + 1, steps))
    step_fn = make_train_step(cfg, opt)
    state = init_train_state(mdl.init_params(cfg, 0, device=dev), opt)
    pipe = TokenPipeline(cfg.vocab_size, batch, seq, seed=0)
    extras = frontend_stubs(cfg, batch, dev)
    t0 = time.perf_counter()
    records = []
    for i in range(steps):
        b = pipe.next_batch()
        data = {"tokens": torch.from_numpy(b.tokens).to(dev, torch.int64),
                "targets": torch.from_numpy(b.targets).to(dev, torch.int64), **extras}
        state, metrics = step_fn(state, data)
        rec = {k: float(v) for k, v in metrics.items()}
        rec["t"] = time.perf_counter()
        records.append(rec)
        if i % log_every == 0 or i == steps - 1:
            log(f"step {i:5d} loss {rec['loss']:.4f} ce {rec['ce']:.4f} "
                f"gnorm {rec['grad_norm']:.3f} ({rec['t'] - t0:.1f}s)")
    return state, records


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true", help="CPU-sized variant")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    state, records = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
                           device=args.device, log_every=args.log_every)
    losses = [r["loss"] for r in records]
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    print(f"loss: first5={first:.4f} last5={last:.4f} (improved: {last < first})")
    if args.checkpoint:
        save_checkpoint(args.checkpoint, train_state_tree(state), step=args.steps)
        print(f"checkpoint -> {args.checkpoint}")


if __name__ == "__main__":
    main()
