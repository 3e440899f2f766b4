"""Device operations per traced step."""

from portbench.readers import launches


def read(run):
    return launches(run)
