"""aggregate_roofline: B2's least time a round — the (m, d) f32 rows and
the weights read once, the (d,) sum written once, at the HBM peak — over
the device time of the ops its name files list."""
from perfbench import trace, work

NAME = "aggregate_roofline"
UNIT = "%"
LAYER = "aggregate kernel"
MOVES = "tokens_per_s"
SOURCE = "device_trace"


def read(run):
    spent, calls = run.trace.op_seconds(trace.patterns(NAME))
    if calls == 0 or spent <= 0:
        return None
    least = len(run.rounds) * work.least_time(*work.aggregate_work(run.traffic["m"], run.d))
    return 100.0 * least / spent
