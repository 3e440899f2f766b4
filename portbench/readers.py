"""Arithmetic the metric readers (``metrics/<name>.py``) share. A reader
takes the run's context and returns its number, or None where the run
has nothing for it to read; a share of a roofline or of a peak is never
made up as 0."""

from __future__ import annotations

import statistics

from portbench import costs


def traced(run):
    """The run's trace summary if it is traced and on the card (a CPU run
    has no device operations to read)."""
    if run.trace_summary is None or run.device.type != "cuda":
        return None
    return run.trace_summary


def host_ms(run):
    return statistics.median(run.host_ms) if run.host_ms else None


def launches(run):
    tr = traced(run)
    return None if tr is None else len(tr.ops) / run.trace_steps


def eager_ms(run):
    tr = traced(run)
    return None if tr is None else tr.eager_seconds() / run.trace_steps * 1e3


def one_shape(run):
    """The ``(m, n)`` every GP of the run shares, else None (the kernels'
    names do not say which GP a launch served)."""
    shapes = set(run.gp_shapes)
    return next(iter(shapes)) if len(shapes) == 1 else None


def roofline(run, kind):
    """A hand-written kernel's share of its roofline, in %: the least time
    of its traced launches (:func:`portbench.costs.kernel_least_s`; the
    gathering draw at the run's mean distinct ancestors) over their
    device time."""
    tr = traced(run)
    shape = one_shape(run)
    if tr is None or shape is None:
        return None
    seconds, count = tr.kernel_seconds(kind)
    if not count or seconds <= 0:
        return None
    distinct = None
    if kind == "draw":
        if run.distinct is None:
            return None
        distinct = int(round(run.distinct))
    least = costs.kernel_least_s(kind, shape[0], shape[1], run.N, distinct)
    return 100.0 * count * least / seconds


def step_mfu(run):
    """The steps' share of the card's peak, in %: the least time of a step
    (:func:`portbench.costs.step_least_s`) times the steps of the window,
    over the window, the traced and probed steps left out; the
    log-determinants counted where the run's step computes them."""
    if traced(run) is None:
        return None
    if run.clean_steps <= 0 or run.clean_s <= 0:
        return None
    least = costs.step_least_s(run.gp_shapes, run.dx, run.N, logdets=run.logdets)
    return 100.0 * run.clean_steps * least / run.clean_s


def idle_share(run):
    tr = traced(run)
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
