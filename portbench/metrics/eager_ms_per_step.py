"""Device milliseconds per traced step of the operations that are not
hand-written kernels."""

from portbench.readers import eager_ms


def read(run):
    return eager_ms(run)
