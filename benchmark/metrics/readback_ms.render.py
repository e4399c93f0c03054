"""readback_ms.render: host milliseconds a pass spends in the program's
``ss.readback`` spans, copying the chunk sums to the host after the
device's tail (``program_spans.host_ms``)."""

from benchmark import program_spans
from benchmark.common import PASS_SPAN


def read(run):
    return program_spans.host_ms(run, "render", PASS_SPAN, program_spans.READBACK)
