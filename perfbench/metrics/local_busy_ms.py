"""local_busy_ms: device-busy ms a client's local step — the union of the
device ops that ran inside the ``round_step`` spans, without B2's
aggregate, over the local steps of the traced rounds."""
from perfbench import trace

NAME = "local_busy_ms"
UNIT = "ms"
LAYER = "local step"
MOVES = "tokens_per_s"
SOURCE = "device_trace"


def read(run):
    steps = len(run.rounds) * run.traffic["m"] * run.traffic["local_steps"]
    t = run.trace
    mask = t.mask(span="round_step") & ~t.mask(names=trace.patterns("aggregate_roofline"))
    if steps == 0 or not mask.any():
        return None
    return 1e3 * t.busy_seconds(mask) / steps
