"""meng_device_share.train: the Meng 2015 albedo's share of a train step's
device time: the kernels launched inside the program's ``ss.meng`` span
(the grid walk, the point weights, their contraction with the point
spectra and the hero reconstruction, once per bounce) over all the step's
kernels (``program_spans.device_share``)."""

from benchmark import program_spans
from benchmark.common import STEP_SPAN
from benchmark.meng_work import MENG


def read(run):
    return program_spans.device_share(run, "train", STEP_SPAN, MENG)
