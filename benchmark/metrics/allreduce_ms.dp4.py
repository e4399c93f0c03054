"""allreduce_ms.dp4: the all-reduces' own device time in a train step over
several cards, in milliseconds: for each traced step the least over the
ranks of its NCCL kernels' device time (an all-reduce's kernel runs until
the slowest rank joins, and the rank that joins last waits least, so the
least holds the exchange and not the wait), the median over the steps.
The wait itself is rank 0's NCCL time in ``breakdown``."""

import statistics


def read(run):
    least = run.facts.get("nccl_us_least_rank")
    if run.kind != "train" or run.device_count < 2 or not least or not any(least):
        return None
    return statistics.median(least) / 1e3
