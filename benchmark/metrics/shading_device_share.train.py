"""shading_device_share.train: the shading phase's share of a train step's
device time: the kernels launched inside the program's ``ss.shading`` span
(material spectra, the throughput and radiance chain, the XYZ estimator)
over all the step's kernels (``program_spans.device_share``)."""

from benchmark import program_spans
from benchmark.common import STEP_SPAN


def read(run):
    return program_spans.device_share(run, "train", STEP_SPAN, program_spans.SHADING)
