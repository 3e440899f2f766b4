"""The step's share of the card's peak (bytes or float32 flops), in %."""

from portbench.readers import step_mfu


def read(run):
    return step_mfu(run)
