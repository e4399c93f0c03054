"""launches_per_pass.render: kernel launches the host makes in one traced
pass of the progressive renderer (``readers.launches_per_call``)."""

from benchmark import readers
from benchmark.common import PASS_SPAN


def read(run):
    return readers.launches_per_call(run, "render", PASS_SPAN)
