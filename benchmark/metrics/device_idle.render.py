"""device_idle.render: the device's idle share of a pass of the
progressive renderer: ``readers.device_idle`` of the traced passes."""

from benchmark import readers
from benchmark.common import PASS_SPAN


def read(run):
    return readers.device_idle(run, "render", PASS_SPAN)
