"""device_idle.train: the device's idle share of a train step:
``readers.device_idle`` of the traced steps (rank 0's over several
cards)."""

from benchmark import readers
from benchmark.common import STEP_SPAN


def read(run):
    return readers.device_idle(run, "train", STEP_SPAN)
