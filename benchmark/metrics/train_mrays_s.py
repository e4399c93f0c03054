"""train_mrays_s: rays of every train step completed in the window, over
the window's host-clock seconds, in millions (``readers.rate_mrays_s``).
Rays are counted as bench.py counts them: lanes x samples x 19 with
explicit light sampling at depth 10 (``common.rays_per_sample``)."""

from benchmark import readers


def read(run):
    return readers.rate_mrays_s(run, "train")
