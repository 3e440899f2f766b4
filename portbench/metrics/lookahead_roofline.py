"""The lookahead kernel's share of its roofline, in %."""

from portbench.readers import roofline


def read(run):
    return roofline(run, "lookahead")
