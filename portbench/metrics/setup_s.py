"""Seconds from the process's start to the window's start: imports, the
card, the kernels' build or load, the record, the warm-up."""


def read(run):
    return run.setup_s
