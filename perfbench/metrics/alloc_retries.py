"""alloc_retries: the caching allocator's retries (a cudaMalloc that failed,
the cache freed, then retried) over the measured window."""

NAME = "alloc_retries"
UNIT = "count"
LAYER = "device"
MOVES = "tokens_per_s"
SOURCE = "program_counter"


def read(run):
    return run.counters.get("alloc_retries")
