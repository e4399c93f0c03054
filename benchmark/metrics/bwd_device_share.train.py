"""bwd_device_share.train: the backward's share of a train step's device
time: one minus the device time of ``forward_only_step`` on the same
inputs over the step's (each the union of its kernels' intervals)."""

from benchmark.common import FORWARD_SPAN, STEP_SPAN


def read(run):
    tr = run.trace
    if run.kind != "train" or tr is None or not tr.spans.get(FORWARD_SPAN):
        return None
    step = tr.busy_us(STEP_SPAN) / len(tr.spans[STEP_SPAN])
    fwd = tr.busy_us(FORWARD_SPAN) / len(tr.spans[FORWARD_SPAN])
    return 1.0 - fwd / step if step > 0 else None
