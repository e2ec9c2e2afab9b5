"""plan_build_ms: the plan service's own wall-clock ms of each rebuild
(distances, Ward, the cut, the urns), the mean over the traced rounds."""

NAME = "plan_build_ms"
UNIT = "ms"
LAYER = "sampling"
MOVES = "sampling_ms"
SOURCE = "program_span"


def read(run):
    vals = [r["plan_build_ms"] for r in run.rounds if r.get("plan_build_ms", -1.0) >= 0]
    return sum(vals) / len(vals) if vals else None
