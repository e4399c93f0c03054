"""launches_per_step.dp4: kernel launches rank 0's host makes in one traced
train step over several cards (``readers.launches_per_call``)."""

from benchmark import readers
from benchmark.common import STEP_SPAN


def read(run):
    return readers.launches_per_call(run, "train", STEP_SPAN) if run.device_count > 1 else None
