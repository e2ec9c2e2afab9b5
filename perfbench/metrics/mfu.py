"""mfu: model FLOPs of the measured rounds (6 · active parameters · tokens,
:func:`perfbench.work.model_flops`) at the card's dense bf16 peak, over the
traced window's wall time."""
from perfbench import work

NAME = "mfu"
UNIT = "%"
LAYER = "round driver"
MOVES = "tokens_per_s"
SOURCE = "device_trace"


def read(run):
    if not run.rounds or run.trace.window_s <= 0:
        return None
    flops = work.model_flops(run.n_active, run.tokens_per_round * len(run.rounds), "train")
    return 100.0 * flops / (work.PEAK_FLOPS * run.trace.window_s)
