"""Reduction of one traced window of ``torch.profiler`` to what the
per-layer metrics read: device busy time (the union of the device
operations' intervals), the device operations by name, the idle gaps by
what the host was doing, and launches.

The window is the span of the ``portbench.window`` annotation the
workload records around the traced steps (its final synchronisation
included), on the trace's own clock.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from collections import defaultdict

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
# the device functions of bipk_tpu_torch/csrc/ (the hand-written kernels)
OURS = ("packed_mniw_kernel", "systematic_scan_kernel", "systematic_kernel",
        "factor_gather_kernel", "dedup_gather_kernel", "unpacked_mniw_kernel",
        "project_kernel", "warp_mniw_kernel")
WARP = re.compile(r"warp_mniw_kernel<(\d+),\s*(\d+)>")
# warp_mniw_kernel's modes (csrc/warp_mniw.cu): kProject, kDraw, kLogdets
WARP_MODES = {0: "lookahead", 1: "draw", 2: "logdets"}
# host operations, before a gap's end, searched for the one that covers
# most of the gap (what the host was doing while the card idled)
LOOK_BACK = 64


def kernel_kind(name: str) -> str | None:
    """``lookahead``, ``draw``, ``logdets`` or ``resample`` for the
    hand-written kernels the metrics read, else None."""
    m = WARP.search(name)
    if m:
        return WARP_MODES.get(int(m.group(1)))
    if "systematic_scan_kernel" in name:
        return "resample"
    return None


def is_ours(name: str) -> bool:
    return any(k in name for k in OURS)


def short(name: str) -> str:
    name = re.sub(r"^void ", "", name)
    return name if len(name) <= 100 else name[:97] + "..."


def _union(intervals):
    total, end = 0.0, None
    merged = []
    for s, e in sorted(intervals):
        if end is None or s > end:
            merged.append([s, e])
            end = e
        elif e > end:
            merged[-1][1] = e
            end = e
    for s, e in merged:
        total += e - s
    return total, merged


class TraceSummary:
    """One traced window: ``window_s``, ``busy_s``, ``ops`` (device
    operations as ``(name, start_us, dur_us)``), ``device_ops`` and
    ``idle_gaps`` (the ten largest, ``[name, seconds]``)."""

    def __init__(self, events: list):
        win = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
               and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError(f"the trace holds no {WINDOW!r} span")
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
        self.window_s = (w1 - w0) * 1e-6
        self.ops = []
        host = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            s, d = float(e["ts"]), float(e["dur"])
            if s + d < w0 or s > w1:
                continue
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                self.ops.append((e.get("name", ""), s, d))
            elif cat in HOST_CATS:
                host.append((e.get("name", ""), s, s + d))
        busy, merged = _union([(max(s, w0), min(s + d, w1)) for _, s, d in self.ops])
        self.busy_s = busy * 1e-6
        by_name = defaultdict(float)
        for name, _, d in self.ops:
            by_name[short(name)] += d * 1e-6
        self.device_ops = sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:10]
        gaps, prev = [], w0
        for s, e in merged:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if w1 > prev:
            gaps.append((prev, w1))
        idle = defaultdict(float)
        host.sort(key=lambda h: h[1])
        starts = [h[1] for h in host]
        for g0, g1 in gaps:
            best, most = "host: no traced operation", 0.0
            j = bisect.bisect_left(starts, g1)
            for name, s, e in host[max(0, j - LOOK_BACK):j]:
                over = min(e, g1) - max(s, g0)
                if over > most:
                    best, most = name, over
            idle[best] += (g1 - g0) * 1e-6
        self.idle_gaps = sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1])[:10]

    def kernel_seconds(self, kind: str):
        """``(total seconds, launches)`` of the hand-written kernel ``kind``."""
        ds = [d for name, _, d in self.ops if kernel_kind(name) == kind]
        return sum(ds) * 1e-6, len(ds)

    def eager_seconds(self) -> float:
        """Device seconds of the operations that are not hand-written."""
        return sum(d for name, _, d in self.ops if not is_ours(name)) * 1e-6


def warm_up(device):
    """Start and stop the profiler once, so that its first start (CUPTI's
    set-up, seconds) falls in the set-up and not in a window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts):
        torch.ones(8, device=device).sum()


def summarize(prof) -> TraceSummary:
    """Export ``prof``'s chrome trace to a temporary file, read it and
    delete it."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return TraceSummary(events)
