"""Host milliseconds to enqueue one step on an idle card (the median of
the probed steps)."""

from portbench.readers import host_ms


def read(run):
    return host_ms(run)
