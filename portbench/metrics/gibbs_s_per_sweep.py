"""The window's seconds times the steps of a sweep over the cSMC steps
completed in the window."""


def read(run):
    if getattr(run, "algorithm", None) != "gibbs" or not run.steps:
        return None
    return run.window_s * run.sweep_steps / run.steps
