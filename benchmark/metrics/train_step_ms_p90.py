"""train_step_ms_p90: the 90th percentile of the window's step times, each
from the step's start to its loss on the host (rank 0's, after the
all-reduce, over several cards), in milliseconds."""

import statistics


def read(run):
    if run.kind != "train" or len(run.step_s) < 2:
        return None
    return statistics.quantiles([s * 1e3 for s in run.step_s], n=10, method="inclusive")[8]
