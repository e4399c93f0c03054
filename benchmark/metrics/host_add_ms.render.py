"""host_add_ms.render: host milliseconds a pass spends in the program's
``ss.host_add`` spans, adding the chunk sums into the float64 accumulator
(``program_spans.host_ms``)."""

from benchmark import program_spans
from benchmark.common import PASS_SPAN


def read(run):
    return program_spans.host_ms(run, "render", PASS_SPAN, program_spans.HOST_ADD)
