"""A copy of the benchmark at a size the CPU tests can hold: the manifest
and the files of ``portbench/`` that a run finds by name (configurations
and their builders, traffic, limits, drivers, the reference's models,
metric readers) in a temporary root, with fewer particles and a shorter
record; the modules they import are the benchmark's own."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def tiny_root(tmp: Path, particles: int = 256, t_end: float = 0.4) -> Path:
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for sub in ("configs", "traffic", "limits", "metrics", "drivers", "reference/models"):
        shutil.copytree(HERE / sub, tmp / "portbench" / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for p in (tmp / "portbench" / "traffic").glob("*.json"):
        d = json.loads(p.read_text())
        d.update(particles=particles, trace_from=2, trace_steps=2, probe_steps=2,
                 checked_steps=2, warmup_steps=2)
        p.write_text(json.dumps(d))
    for p in (tmp / "portbench" / "configs").glob("*.json"):
        d = json.loads(p.read_text())
        d["t_end"] = t_end
        p.write_text(json.dumps(d))
    return tmp


def run(root: Path, cell: str, seed: int = 2_200_000_017, seconds: float = 120.0,
        trace: int = 0) -> dict:
    """One CPU run of ``cell`` from ``root`` (the card's check skipped),
    its window closed once the judged steps have run (or after
    ``seconds``)."""
    import time

    from portbench import harness

    return harness.run(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                        "--trace", str(trace)], time.perf_counter(), device="cpu", root=root,
                       until_checked=True)
