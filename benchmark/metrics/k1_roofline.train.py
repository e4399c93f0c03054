"""k1_roofline.train: kernel K1's share of its roofline in the traced train
steps, in percent: the least time of one launch (``yardstick.k1_work`` of
the launch's rays and triangles against the published FP32 and HBM peaks)
over K1's mean device time per launch (``best_key_kernel`` in the
profiler's timeline)."""

from benchmark import yardstick
from benchmark.common import STEP_SPAN


def read(run):
    tr = run.trace
    if run.kind != "train" or tr is None:
        return None
    k1 = tr.kernels_in(STEP_SPAN, yardstick.K1_KERNEL)
    if not k1:
        return None
    mean_s = sum(e - s for _, s, e in k1) / len(k1) / 1e6
    return 100.0 * yardstick.bound_s(*yardstick.k1_work(run.facts["k1_rays"], run.facts["n_tris"])) / mean_s
