"""setup_s: seconds from the process's start to the first timed call:
imports, the CUDA context, tables and scene, kernel builds (at a checkout's
first run) and the warm-up calls; over several cards, until every rank is
ready."""


def read(run):
    return run.setup_s
