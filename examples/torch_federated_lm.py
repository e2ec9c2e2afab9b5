"""End-to-end driver: clustered-sampling FL over a transformer LM, on the
PyTorch port.

The port's federated LM driver (``repro_torch.launch.fl_train``) training
a reduced qwen3-family decoder across 16 synthetic clients: each round the
sampler draws m clients, each runs N local SGD steps, and the weighted
parameter combine (eq. 4) runs through the aggregate kernel. As
``examples/federated_lm.py``, plus ``--device`` (the card by default;
``--device cpu`` runs the kernels' plain versions).

Run:  PYTHONPATH=src python examples/torch_federated_lm.py --device cpu [--sampler algorithm1]
"""
import argparse
import contextlib
import dataclasses

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import ClientPopulation
from repro_torch.device import resolve_device
from repro_torch.launch.fl_train import FLLMConfig, make_lm_sampler, run_federated_lm
from repro_torch.models import model as mdl


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--sampler", choices=("md", "algorithm1", "algorithm2"), default="algorithm1"
    )
    ap.add_argument(
        "--planner", choices=("sync", "async"), default="sync",
        help="algorithm2 only: rebuild the plan inline or overlapped with "
        "the next round's local work",
    )
    ap.add_argument(
        "--rebuild-every", type=int, default=1,
        help="algorithm2 only: re-cluster every k observed rounds "
        "(PlannerSpec cadence; 1 = the paper's every-round rebuild)",
    )
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config("qwen3-0.6b", reduced=True)
    cfg = dataclasses.replace(cfg, d_model=64, vocab_size=256, n_heads=2, n_kv_heads=2, head_dim=32)
    planner = {"mode": args.planner, "rebuild_every": args.rebuild_every}
    fl = FLLMConfig(
        n_clients=16, m=4, n_rounds=args.rounds, n_local_steps=2,
        local_batch=2, seq_len=32, lr=0.1,
        sampler=args.sampler,
        planner=planner if args.sampler == "algorithm2" else "sync",
    )
    pop = ClientPopulation(np.full(fl.n_clients, 1000))
    # only algorithm2's gradient store needs the flattened model size
    d = (
        mdl.param_count(mdl.init_params(cfg, 0, device="meta"))
        if args.sampler == "algorithm2"
        else 0
    )
    with contextlib.closing(make_lm_sampler(fl, pop, update_dim=d, device=dev)) as sampler:
        print(f"federated LM ({cfg.name}, {args.sampler}"
              + (f", planner={planner}" if args.sampler == "algorithm2" else "")
              + f"); {fl.n_clients} clients, m={fl.m}, N={fl.n_local_steps} local steps, "
              f"on {dev}")
        losses = run_federated_lm(cfg, fl, sampler, device=dev)
    for t, l in enumerate(losses):
        print(f"  round {t:2d}  mean local loss {l:.4f}")
    print(f"improved: {losses[-1] < losses[0]}")


if __name__ == "__main__":
    main()
