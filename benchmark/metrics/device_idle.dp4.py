"""device_idle.dp4: the device's idle share of a train step over several
cards, rank 0's: ``readers.device_idle`` of its traced steps."""

from benchmark import readers
from benchmark.common import STEP_SPAN


def read(run):
    return readers.device_idle(run, "train", STEP_SPAN) if run.device_count > 1 else None
