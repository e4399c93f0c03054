"""render_mrays_s: rays of every pass whose sums are in the host
accumulator by the window's end, over the window's host-clock seconds, in
millions: pixels x samples x rays per sample (``max_depth`` without
explicit light sampling)."""

from benchmark import readers


def read(run):
    return readers.rate_mrays_s(run, "render")
