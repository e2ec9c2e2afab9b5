"""mfu.sampling: the least time of the sampling step's counted work — B3's
sketch of the observed rows and B1's Gram of the store, each the larger of
its operations at the dense bf16 peak and its bytes at the HBM peak — over
the host's synchronised wall time of ``sample`` and ``observe_updates``,
the time ``sampling_ms`` reports, so that it bounds a gain there whatever
part of the step (device kernels or host work) the gain comes from."""
from perfbench import work

NAME = "mfu.sampling"
UNIT = "%"
LAYER = "sampling"
MOVES = "sampling_ms"
SOURCE = "host_clock"


def read(run):
    spent = sum(r["sample_s"] + r["observe_s"] for r in run.rounds)
    if not run.rounds or spent <= 0 or not run.sketch_dim:
        return None
    least = sum(work.least_time(*work.sketch_work(r["n_observed"], run.d, run.sketch_dim))
                + work.least_time(*work.gram_work(run.traffic["n_clients"], run.sketch_dim))
                for r in run.rounds)
    return 100.0 * least / spent
