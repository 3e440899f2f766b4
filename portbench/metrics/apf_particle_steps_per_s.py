"""Particle-steps filtered in the window over the window's wall time (host
clock, ending in a synchronisation)."""


def read(run):
    if getattr(run, "algorithm", None) != "apf" or run.window_s <= 0:
        return None
    return run.particle_steps / run.window_s
