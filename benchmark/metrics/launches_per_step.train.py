"""launches_per_step.train: kernel launches the host makes in one traced
train step (``readers.launches_per_call``)."""

from benchmark import readers
from benchmark.common import STEP_SPAN


def read(run):
    return readers.launches_per_call(run, "train", STEP_SPAN)
