"""idle_share: the share of the traced window in which no device op ran."""

NAME = "idle_share"
UNIT = "%"
LAYER = "device"
MOVES = "tokens_per_s"
SOURCE = "device_trace"


def read(run):
    t = run.trace
    if t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
