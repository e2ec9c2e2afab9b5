"""The benchmark's data, found by name: ``BENCHMARK.json``'s cells, the
configuration files under ``perfbench/configs``, the traffic mixes under
``perfbench/traffic`` and the limits under ``perfbench/limits``; and the
architecture those files describe, as the plain reference builds it.

Nothing here imports the port: the reference and the harness read the
same files.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str) -> dict:
    """The ``workloads`` entry named ``name``, with its configuration's
    file, its traffic mix, its limits and its metrics' entries loaded."""
    bench = benchmark()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = dict(found[0])
    cfg_entry = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    w["config_file"] = load_json(ROOT / cfg_entry["file"])
    w["traffic_file"] = traffic(w["traffic"])
    w["limits"] = limits(name)
    w["end_to_end"] = [m for m in bench["end_to_end"]
                       if name in m.get("workloads", [name])]
    w["per_layer"] = [m for m in bench["per_layer"]
                      if name in m.get("workloads", [name])]
    return w


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def limits(cell_name: str) -> dict:
    """{number: limit} the cell's comparison holds the program to."""
    return load_json(HERE / "limits" / f"{cell_name}.json")["limits"]


@dataclasses.dataclass(frozen=True)
class Arch:
    """What the plain reference needs of a configuration file."""

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    tie: bool
    rope_theta: float
    eps: float
    qkv_bias: bool


def arch(cfg: dict) -> Arch:
    """A configuration file -> :class:`Arch` (published key names)."""
    port = cfg.get("port", {})
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return Arch(
        n_layers=cfg["num_hidden_layers"], d_model=d, n_heads=h,
        n_kv_heads=cfg["num_key_value_heads"], head_dim=cfg.get("head_dim") or d // h,
        d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        tie=bool(cfg["tie_word_embeddings"]), rope_theta=float(cfg["rope_theta"]),
        eps=float(cfg["rms_norm_eps"]),
        qkv_bias=bool(port.get("qkv_bias", cfg.get("attention_bias", False))))
