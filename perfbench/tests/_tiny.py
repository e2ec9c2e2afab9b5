"""Tiny widths of the benchmark's architecture and a cell's whole
comparison run at them, shared by the CPU and the card tests."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import check, run, spec  # noqa: E402
from perfbench.driver import Federation  # noqa: E402

#: tiny widths of each configuration, f32 compute so that a sound
#: program run sits far inside the cells' limits
TINY = {
    "qwen2-1.5b": {
        "name": "tiny-qwen2", "hidden_size": 64, "intermediate_size": 128,
        "num_attention_heads": 4, "num_key_value_heads": 2, "num_hidden_layers": 2,
        "vocab_size": 256, "rope_theta": 1e6, "rms_norm_eps": 1e-6,
        "tie_word_embeddings": True, "hidden_act": "silu",
        "port": {"arch": "qwen2-1.5b", "n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
                 "d_ff": 128, "vocab_size": 256, "qkv_bias": True, "dtype": "float32",
                 "param_dtype": "float32", "remat": True, "fused_ce": True},
    },
}


def tiny_cell(name: str) -> dict:
    """A cell of BENCHMARK.json at tiny widths: its mix cut to 8 clients, 4
    a round, batches of 2 × 32, a 16-wide sketch; its own limits."""
    c = spec.cell(name)
    t = copy.deepcopy(c["traffic_file"])
    t.update(n_clients=8, m=4, local_batch=2, seq_len=32)
    t["stream"]["batches_per_client"] = 64
    if t["planner"].get("sketch_dim"):
        t["planner"]["sketch_dim"] = 16
    return {**c, "traffic_file": t, "config_file": copy.deepcopy(TINY[c["config"]])}


def run_on(cell: dict, device, seed: int = 4_000_000_017) -> tuple[bool, dict]:
    """What ``perfbench.run`` does after its look for a card, on ``device``."""
    traffic = cell["traffic_file"]
    fed = Federation(cell["config_file"], traffic, seed, device)
    setup = run.setup_rounds(fed, seed, traffic["checked_rounds"])
    records, _, _ = run.window(fed, 0.0, traffic["checked_rounds"], False)
    feedback = fed.feedback
    fed.close()
    numbers, _ = run.reference_numbers(cell, feedback, setup, records, seed, device)
    ok, _ = check.verdict(numbers, cell["limits"])
    return ok, numbers
