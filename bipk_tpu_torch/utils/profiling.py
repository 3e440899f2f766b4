"""Profiling and throughput instrumentation (port of
``bipk_tpu/utils/profiling.py``): wall-clock timers that wait for the
card, and an optional ``torch.profiler`` trace around a region."""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)


def block(tree):
    """Wait until the CUDA devices that the tensors of ``tree`` (nested
    tuples, lists, dicts, NamedTuples) live on have finished their work;
    returns ``tree``."""
    for device in {t.device for t in _leaves(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(device)
    return tree


@dataclass
class Timer:
    """Accumulating wall-clock timer with throughput reporting."""

    name: str = "timer"
    elapsed: float = 0.0
    count: int = 0
    _start: float = field(default=0.0, repr=False)

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed += time.perf_counter() - self._start
        self.count += 1
        return False

    def throughput(self, units: float) -> float:
        """Units processed per second over the accumulated time."""
        return units / self.elapsed if self.elapsed > 0 else float("inf")


def timed(fn, *args, **kwargs):
    """Run ``fn``, wait for its outputs, return ``(result, seconds)``."""
    start = time.perf_counter()
    out = block(fn(*args, **kwargs))
    return out, time.perf_counter() - start


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """Run the region under ``torch.profiler`` with the CPU and (where
    this PyTorch has it) the CUDA activity, and write its Chrome trace to
    ``log_dir/trace.json``; with no directory, run it unprofiled. Yields
    the profiler, or None."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, supported_activities

    activities = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
                  if a in supported_activities()]
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
