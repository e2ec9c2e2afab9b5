"""The system under test: the port's federated LM round, driven as
``run_federated_lm`` drives it, on inputs the benchmark makes.

Each round: ``sampler.sample(t)``; the drawn clients' batches, made on the
device (:mod:`perfbench.generate`), stacked with the distinct clients first
by id and a repeated draw after them; the round step from
``make_fl_round_step`` (m local SGD steps, B2's aggregate, the updates in
place); ``sampler.observe_updates`` on the distinct clients' rows (B3's
sketch, the store's scatter, the plan rebuild). The harness re-implements
none of these; it adds spans around the three calls and host clocks that
end in a synchronise.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch.profiler import record_function

from perfbench import generate
from perfbench.reference.lm import flat_leaves, views
from perfbench.spec import arch

#: published key -> the port's ModelConfig attribute that holds it
KEYS = {
    "hidden_size": "d_model",
    "intermediate_size": "d_ff",
    "num_attention_heads": "n_heads",
    "num_key_value_heads": "n_kv_heads",
    "num_hidden_layers": "n_layers",
    "vocab_size": "vocab_size",
    "rope_theta": "rope_theta",
    "rms_norm_eps": "norm_eps",
    "tie_word_embeddings": "tie_embeddings",
    "hidden_act": "act",
}


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _attr(obj, path: str):
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def port_config(cfg: dict):
    """The configuration file -> the port's ModelConfig, checked key by key
    against the published numbers the file states."""
    from repro_torch.configs import get_config

    port = cfg["port"]
    mc = get_config(port["arch"])
    fields = {f.name for f in dataclasses.fields(mc)}
    changes = {k: v for k, v in port.items() if k in fields and k != "name"}
    mc = dataclasses.replace(mc, **changes)
    mc.validate()
    bad = [(k, cfg[k], _attr(mc, p)) for k, p in KEYS.items() if k in cfg and cfg[k] != _attr(mc, p)]
    if mc.moe is not None or mc.mla is not None or mc.first_blocks:
        bad.append(("architecture", "dense GQA", "MoE, MLA or leading blocks"))
    if bad:
        raise ValueError(f"{cfg['name']}: the file and the port's config disagree: {bad}")
    return mc


class Federation:
    """The port's round, its sampler and the global model, on the card."""

    def __init__(self, cfg_file: dict, traffic: dict, seed: int, device):
        from repro_torch.core.types import ClientPopulation
        from repro_torch.launch.fl_train import FLLMConfig, make_fl_round_step, make_lm_sampler
        from repro_torch.models import model as mdl

        self.traffic = traffic
        self.device = device
        self.cfg = port_config(cfg_file)
        self.arch = arch(cfg_file)
        self.leaves = flat_leaves(self.arch)
        like = mdl.init_params(self.cfg, 0, device="meta")
        self.d = mdl.param_count(like)
        flat = torch.empty(self.d, dtype=torch.float32, device=device)
        self.params = mdl.lm_views(flat, like)
        theta_0 = generate.theta0(self.leaves, seed, device)
        self.load(theta_0)
        del theta_0
        self.table = generate.token_table(traffic, self.arch.vocab, seed, device)
        self.cursor = np.zeros(traffic["n_clients"], dtype=np.int64)
        self.m = traffic["m"]
        self.n_local = traffic["local_steps"]
        fl = FLLMConfig(n_clients=traffic["n_clients"], m=self.m, n_local_steps=self.n_local,
                        local_batch=traffic["local_batch"], seq_len=traffic["seq_len"],
                        lr=traffic["lr"], sampler=dict(traffic["sampler"]), seed=int(seed),
                        planner=dict(traffic["planner"]))
        self.population = ClientPopulation(np.full(traffic["n_clients"], traffic["client_samples"]))
        self.sampler = make_lm_sampler(fl, self.population, update_dim=self.d, device=device)
        self.feedback = bool(getattr(self.sampler, "consumes_updates", False))
        self.step = make_fl_round_step(self.cfg, fl.lr, self.n_local, with_updates=self.feedback)
        self.weights = torch.full((self.m,), 1.0 / self.m, dtype=torch.float32, device=device)
        self.tokens_per_round = self.m * self.n_local * traffic["local_batch"] * traffic["seq_len"]

    def load(self, flat_theta: torch.Tensor) -> None:
        named = dict(self.params.named_parameters())
        mine = views(flat_theta, self.leaves)
        if set(named) != set(mine):
            raise ValueError(f"parameter names differ: {sorted(set(named) ^ set(mine))[:8]}")
        with torch.no_grad():
            for name, p in named.items():
                p.copy_(mine[name])

    def round(self, t: int) -> dict:
        """One round; returns its record (draws, loss, host times)."""
        rec = {"t": t}
        t0 = time.perf_counter()
        with record_function("sample"):
            res = self.sampler.sample(t)
        t1 = time.perf_counter()
        clients = np.asarray(res.clients)
        js = []
        for c in clients:  # batches in the sampler's order, as run_federated_lm
            n0 = int(self.cursor[c])
            self.cursor[c] += self.n_local
            js.append([(n0 + i) % self.table.shape[1] for i in range(self.n_local)])
        ids, first = np.unique(clients, return_index=True)
        order = np.concatenate([first, np.setdiff1d(np.arange(len(clients)), first)])
        draws = [(int(clients[i]), js[i]) for i in order]
        toks, tgts = generate.batches(self.table, self.traffic, self.arch.vocab, draws)
        with record_function("round_step"):
            out = self.step(self.params, toks, tgts, self.weights)
            sync(self.device)
        t2 = time.perf_counter()
        if self.feedback:
            self.params, loss, updates = out
            with record_function("observe_updates"):
                self.sampler.observe_updates(ids.astype(np.int64), updates[:len(ids)])
                sync(self.device)
            del updates
            rec["plan_build_ms"] = float(self.sampler.plan_cost_telemetry()[0])
        else:
            self.params, loss = out
        t3 = time.perf_counter()
        del out
        rec["loss"] = float(loss)
        t4 = time.perf_counter()
        rec.update(clients=clients.tolist(), draws=draws, n_observed=len(ids),
                   sample_s=t1 - t0, step_s=t2 - t1, observe_s=t3 - t2,
                   round_s=t4 - t0, start=t0, end=t4)
        return rec

    def store_rows(self) -> np.ndarray:
        return self.sampler.gradient_store.asnumpy()

    def plan_tokens(self) -> np.ndarray:
        return np.asarray(self.sampler.plan.r_tokens).copy()

    def close(self) -> None:
        self.sampler.close()
