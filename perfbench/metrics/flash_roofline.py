"""flash_roofline: the least time of one causal B4 forward an attention
layer a local step (:func:`perfbench.work.flash_work`, bf16), over the
device time of the ops its name files list. Remat's recompute launches
the forward again; it is not counted as work."""
from perfbench import trace, work

NAME = "flash_roofline"
UNIT = "%"
LAYER = "attention kernel"
MOVES = "tokens_per_s"
SOURCE = "device_trace"


def read(run):
    a, tr = run.arch, run.traffic
    layers = a.n_layers  # every layer of the reference's architecture is attention
    spent, calls = run.trace.op_seconds(trace.patterns(NAME))
    if layers == 0 or calls == 0 or spent <= 0:
        return None
    per_call = work.least_time(*work.flash_work(tr["local_batch"], tr["seq_len"], tr["seq_len"],
                                                a.n_heads, a.n_kv_heads, a.head_dim))
    needed = layers * len(run.rounds) * tr["m"] * tr["local_steps"]
    return 100.0 * needed * per_call / spent
