"""The checked rounds of a federated campaign, worked out again in float32.

Each checked round starts from the reference's own global model (the
seed's θ⁰ for the first), trains every drawn client one local SGD step at
a time on the same token batches the program was handed, and aggregates
θ + Σ_k ω_k (θ_k − θ) with ω_k = 1/m. It reports what the comparison reads:
each round's mean local loss, the per-leaf norms of the global model's change
over the first round and over all the checked rounds, and the sketch
columns asked for of each observed client's update.
Which clients a round drew, and in which order the program stacked them,
are the program's outputs; the reference takes them as given here and
judges them in :mod:`perfbench.reference.sampling`.
"""
from __future__ import annotations

import time

import torch

from perfbench import generate
from perfbench.reference import sketch
from perfbench.reference.lm import Model, flat_leaves, leaf_runs, strict_f32, views
from perfbench.spec import Arch


def leaf_norms(u: torch.Tensor, runs) -> torch.Tensor:
    """(L,) f64: the norm of each leaf's run of the flat vector ``u``."""
    return torch.stack([torch.linalg.vector_norm(u[o:o + n], dtype=torch.float64)
                        for _, o, n in runs])


def signs_for(arch: Arch, traffic: dict, seed: int, device) -> sketch.Signs | None:
    """The mix's sketch signs over the flat parameter vector (None without
    a sketch): the store's seed is the run's."""
    d_prime = traffic.get("planner", {}).get("sketch_dim") or 0
    if not d_prime:
        return None
    d = leaf_runs(flat_leaves(arch))[-1]
    return sketch.Signs(d[1] + d[2], range(d_prime), seed, d_prime, device)


def run(arch: Arch, traffic: dict, seed: int, rounds: list, *, device, quant=None,
        signs: sketch.Signs | None = None) -> dict:
    """rounds: for each checked round, ``{"draws": [(client, [batch j a
    local step]), …] in stack order, "observed": [stack row, …]}``;
    ``signs``: the sketch's, to sketch each observed client's update."""
    strict_f32()
    t0 = time.perf_counter()
    leaves = flat_leaves(arch)
    runs = leaf_runs(leaves)
    model = Model(arch, quant)
    theta_0 = generate.theta0(leaves, seed, device)
    table = generate.token_table(traffic, arch.vocab, seed, device)
    lr = float(traffic["lr"])
    # a planted fault of the control's runs: half of each batch left out
    rows = traffic["local_batch"] // 2 if traffic.get("half_batch") else traffic["local_batch"]
    theta = theta_0.clone()
    losses, first, sketches = [], None, []
    for r, rnd in enumerate(rounds):
        draws = rnd["draws"]
        w = 1.0 / len(draws)
        acc = torch.zeros_like(theta)
        client_losses = []
        for k, (client, js) in enumerate(draws):
            toks, tgts = generate.batches(table, traffic, arch.vocab, [(client, js)])
            u = torch.zeros_like(theta)
            step_losses = []
            for n in range(len(js)):  # u = θ_k − θ, kept apart from θ's rounding
                flat = theta + u if n else theta
                P = {k: v.detach().requires_grad_(True) for k, v in views(flat, leaves).items()}
                loss = model.loss(P, toks[0, n, :rows], tgts[0, n, :rows])
                grads = torch.autograd.grad(loss, list(P.values()))
                for (_, o, size), g in zip(runs, grads):  # leaf by leaf: no flat-sized scatter
                    u[o:o + size].sub_(g.reshape(-1), alpha=lr)
                step_losses.append(float(loss.detach()))
                del grads, P, loss
            client_losses.append(sum(step_losses) / len(step_losses))
            if k in rnd["observed"] and signs is not None:
                cols = signs.columns(u).cpu()
                rms = float(torch.linalg.vector_norm(u, dtype=torch.float64)) / signs.d_prime ** 0.5
                sketches.append((r, client, cols, rms))
            acc.add_(u, alpha=w)
            del u
        theta = theta + acc
        del acc
        losses.append(sum(client_losses) / len(client_losses))
        if r == 0:
            first = leaf_norms(theta - theta_0, runs).cpu()
    change = leaf_norms(theta - theta_0, runs).cpu()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return {"losses": losses, "first_norms": first, "change_norms": change,
            "sketches": sketches, "leaf_names": [name for name, _, _ in runs],
            "seconds": time.perf_counter() - t0}
