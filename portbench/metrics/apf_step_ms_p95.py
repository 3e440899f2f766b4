"""The 95th percentile of the intervals between consecutive step ends in
the window, from a CUDA event recorded after every step."""

import numpy as np


def read(run):
    if getattr(run, "algorithm", None) != "apf" or not getattr(run, "step_ms", None):
        return None
    return float(np.percentile(run.step_ms, 95))
