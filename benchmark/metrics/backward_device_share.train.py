"""backward_device_share.train: the backward's share of a train step's
device time: the kernels launched inside the program's ``ss.backward`` span
(``torch.autograd.grad``, the engine's thread included) over all the step's
kernels (``program_spans.device_share``).  It reads the same step that
``bwd_device_share.train`` reads by difference with a forward-only step."""

from benchmark import program_spans
from benchmark.common import STEP_SPAN


def read(run):
    return program_spans.device_share(run, "train", STEP_SPAN, program_spans.BACKWARD)
