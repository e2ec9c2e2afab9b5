"""sketch_roofline: B3's least time of each round's (c, d) -> (c, d')
sketch — 2·c·d·d' operations at the dense bf16 peak or the rows read once
and the sketch written once at the HBM peak, the larger — over the device
time of the ops its name files list."""
from perfbench import trace, work

NAME = "sketch_roofline"
UNIT = "%"
LAYER = "sketch kernel"
MOVES = "sampling_ms"
SOURCE = "device_trace"


def read(run):
    spent, calls = run.trace.op_seconds(trace.patterns(NAME))
    if calls == 0 or spent <= 0 or not run.sketch_dim:
        return None
    least = sum(work.least_time(*work.sketch_work(r["n_observed"], run.d, run.sketch_dim))
                for r in run.rounds)
    return 100.0 * least / spent
