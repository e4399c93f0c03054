"""k1_roofline.render: kernel K1's share of its roofline in the traced
passes, in percent, counted as ``k1_roofline.train`` counts it."""

from benchmark import yardstick
from benchmark.common import PASS_SPAN


def read(run):
    tr = run.trace
    if run.kind != "render" or tr is None:
        return None
    k1 = tr.kernels_in(PASS_SPAN, yardstick.K1_KERNEL)
    if not k1:
        return None
    mean_s = sum(e - s for _, s, e in k1) / len(k1) / 1e6
    return 100.0 * yardstick.bound_s(*yardstick.k1_work(run.facts["k1_rays"], run.facts["n_tris"])) / mean_s
