"""The benchmark's inputs, made on the device from ``--seed``: the global
model's starting parameters and every client's token stream. The program
and the reference are handed the same.

Parameters: one ``torch.randn`` over the whole flat vector (the stacked
tree's leaf order, :func:`perfbench.reference.lm.flat_leaves`), each
matrix's run scaled by its fan-in as the port's ``init_params`` scales it,
norm scales set to 1 and biases to 0.

Tokens follow ``TokenPipeline``'s per-client structure: a row is
``(base + stride·t) mod V`` for t < S, its targets ``(token + shift) mod V``;
``table[c, j]`` holds the B row bases of client c's j-th batch, drawn once
for all clients and batches, so client c's stream is a function of the
seed and c alone, and every row differs.
"""
from __future__ import annotations

import torch

#: decorrelates the token generator's seed from the parameters'
TOKEN_SALT = 0x5DEECE66D
MASK63 = (1 << 63) - 1


def generator(seed: int, device, salt: int = 0) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((int(seed) ^ salt) & MASK63)


def theta0(leaves, seed: int, device) -> torch.Tensor:
    """leaves: (name, shape, init) in flat order, init ("normal", scale),
    ("ones",) or ("zeros",) -> the flat f32 vector."""
    total = sum(_numel(shape) for _, shape, _ in leaves)
    flat = torch.randn(total, generator=generator(seed, device), device=device, dtype=torch.float32)
    off = 0
    for _, shape, init in leaves:
        n = _numel(shape)
        seg = flat[off:off + n]
        if init[0] == "normal":
            seg.mul_(init[1])
        elif init[0] == "ones":
            seg.fill_(1.0)
        else:
            seg.zero_()
        off += n
    return flat


def token_table(traffic: dict, vocab: int, seed: int, device) -> torch.Tensor:
    """(n_clients, batches_per_client, local_batch) int64 row bases."""
    shape = (traffic["n_clients"], traffic["stream"]["batches_per_client"], traffic["local_batch"])
    return torch.randint(0, vocab, shape, generator=generator(seed, device, TOKEN_SALT),
                         device=device, dtype=torch.int64)


def batches(table: torch.Tensor, traffic: dict, vocab: int, draws) -> tuple[torch.Tensor, torch.Tensor]:
    """draws: [(client, [batch index a local step])] in stack order ->
    tokens, targets (m, N, B, S) int64 on the table's device, made there."""
    base = torch.stack([torch.stack([table[c, j] for j in js]) for c, js in draws])
    pos = torch.arange(traffic["seq_len"], device=table.device, dtype=torch.int64)
    toks = (base[..., None] + traffic["stream"]["stride"] * pos) % vocab
    return toks, (toks + traffic["stream"]["target_shift"]) % vocab


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n
