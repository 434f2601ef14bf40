"""Seconds from the process's start to the end of the warm calls: imports,
the CUDA context, the pool made on the card, one call on each matrix."""


def read(run):
    return run.setup_s
