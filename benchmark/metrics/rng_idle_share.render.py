"""rng_idle_share.render: the share of a pass's device-idle time that the
host spends inside the program's ``ss.rng`` spans, hashing keys and
launching threefry's word operations (``program_spans.idle_share``)."""

from benchmark import program_spans
from benchmark.common import PASS_SPAN


def read(run):
    return program_spans.idle_share(run, "render", PASS_SPAN, program_spans.RNG)
