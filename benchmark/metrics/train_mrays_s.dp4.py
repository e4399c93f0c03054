"""train_mrays_s.dp4: rays of every train step completed in the window over
several cards (all ranks' lanes), over the window's host-clock seconds, in
millions, counted as ``train_mrays_s`` counts them."""

from benchmark import readers


def read(run):
    return readers.rate_mrays_s(run, "train") if run.device_count > 1 else None
