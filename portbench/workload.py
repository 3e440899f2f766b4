"""What the workload drivers share. Every traffic mix is a
``traffic/<mix>.json`` file of parameters; its ``"algorithm"`` names the
driver, ``drivers/<algorithm>.py``, that reads it. A driver defines
``run(ctx)``, which sets up the cell from ``ctx`` (seed, configuration,
traffic, the configuration's builder and reference model), measures the
window and sets the run's readings on ``ctx`` with ``ctx.judge``, and
``readings(ctx, control)``, the check's numbers of the program and of the
control for :mod:`portbench.calibrate`.

Every random number the timed path consumes is drawn by the driver, from
a generator seeded per step from ``--seed`` (:func:`step_seed`), so that
the check can draw a step's numbers again. With ``--trace 1`` the window
also holds, from step ``trace_from`` on (moved past the checked steps),
``probe_steps`` steps each enqueued on an idle card, whose host time is
``host_ms_per_step``, and then ``trace_steps`` profiled steps
(:class:`Segments`).
"""

from __future__ import annotations

import time

import torch

from portbench import trace as trace_mod

MIX = (1 << 61) - 1


def step_seed(seed: int, sweep: int, step: int) -> int:
    """The seed of one step's draws (``step`` -1: the initial particles;
    -2: the backward draw)."""
    return (seed * 1_000_003 + (sweep + 3) * 7_919 * 1_000_033 + step + 5) % MIX


def merge(into: dict, got: dict):
    """Keep the larger reading of each number."""
    for k, v in got.items():
        into[k] = max(into.get(k, 0.0), v)


def clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return type(tree)(*(clone(t) for t in tree)) if hasattr(tree, "_fields") else \
        type(tree)(clone(t) for t in tree)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Segments:
    """The ``--trace 1`` parts of a window, by step index: ``probe_steps``
    steps from ``start`` enqueued on an idle card one by one (before the
    profiler, whose hooks would slow the host), then ``trace_steps``
    profiled steps. Records the host time they take, so that the clean
    window (``clean_s``, ``clean_steps``) leaves them out."""

    def __init__(self, ctx, start: int):
        tr = ctx.traffic
        self.on = ctx.trace
        self.dev = ctx.device
        self.start, self.k, self.p = start, tr["trace_steps"], tr["probe_steps"]
        self.prof = self.span = None
        self.host_ms = []
        self.t_seg = None
        self.excluded_s = 0.0
        self.excluded_steps = 0
        self.summary = None

    def _probing(self, i):
        return self.start <= i < self.start + self.p

    def before(self, i: int):
        """Called before step ``i`` is enqueued."""
        if not self.on:
            return
        if i == self.start:
            self.t_seg = time.perf_counter()
        if self._probing(i):
            sync(self.dev)
            self._probe = time.perf_counter()
        elif i == self.start + self.p:
            from torch.profiler import ProfilerActivity, profile, record_function

            sync(self.dev)
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                             if self.dev.type == "cuda" else [])
            self.prof = profile(activities=acts)
            self.prof.start()
            self.span = record_function(trace_mod.WINDOW)
            self.span.__enter__()
        elif i == self.start + self.p + self.k:
            self._stop()
            self.excluded_s += time.perf_counter() - self.t_seg
            self.excluded_steps += self.k + self.p

    def after(self, i: int):
        """Called once step ``i`` is enqueued."""
        if self.on and self._probing(i):
            self.host_ms.append((time.perf_counter() - self._probe) * 1e3)
            sync(self.dev)

    def _stop(self):
        sync(self.dev)
        self.span.__exit__(None, None, None)
        self.prof.stop()
        self.span = None

    def finish(self):
        """Read the trace; a window that closed inside the traced steps
        ends the trace there."""
        if self.on and self.prof is not None:
            if self.span is not None:
                self._stop()
            self.summary = trace_mod.summarize(self.prof)
            self.prof = None

    def clear_of(self, checked) -> int:
        """The first start at or after ``self.start`` whose segments hold
        no step of ``checked``."""
        s = self.start
        while any(s <= c < s + self.k + self.p for c in checked):
            s += 1
        return s


def finish_ctx(ctx, seg, steps, window_s, setup_s):
    seg.finish()
    ctx.steps = steps
    ctx.window_s = window_s
    ctx.setup_s = setup_s
    ctx.host_ms = seg.host_ms
    ctx.trace_summary = seg.summary
    ctx.trace_steps = seg.k
    ctx.clean_steps = steps - seg.excluded_steps
    ctx.clean_s = window_s - seg.excluded_s


def bitwise_gap(a, b) -> float:
    """The largest ``|a - b|``, equal entries (infinities included) counting
    0 and a NaN where the other differs counting as infinite."""
    d = (a.double() - b.double()).abs()
    d = torch.where(a == b, torch.zeros_like(d), torch.nan_to_num(d, nan=float("inf")))
    return float(d.max()) if d.numel() else 0.0


def flat(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for t in tree for leaf in flat(t)]
