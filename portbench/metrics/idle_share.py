"""The traced window's share in which no operation ran on the card, in %."""

from portbench.readers import idle_share


def read(run):
    return idle_share(run)
