"""One run of one cell: the manifest, the cell's configuration, traffic,
limits, driver and reference model found by name, the card's check, the
workload, the check that decides ``correct``, the metrics and the result
line.

Everything that belongs to one configuration, traffic mix, cell, model,
driver or metric is a file of its own, found by the name
``BENCHMARK.json`` or a data file gives it: ``configs/<config>.json`` and
its builder ``configs/<config>.py``, the reference's model
``reference/models/<model>.py`` (the configuration's ``"model"``),
``traffic/<traffic>.json``, its driver ``drivers/<algorithm>.py`` (the
traffic's ``"algorithm"``), ``limits/<cell>.json``, and the reader
``metrics/<metric>.py``, or, where no file has the metric's whole name,
``metrics/<family>.py`` for the part of the name before its first dot.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# modules that must not be loaded in the process that prints a result:
# JAX and the JAX package (top-level names compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "bipk_tpu")


class Refused(RuntimeError):
    """The run cannot give a result (no card, a forbidden module, a
    missing file); the process exits with a code other than 0."""


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise Refused(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise Refused(f"{path} not found")
    return load_json(path)


def cell_files(man: dict, name: str, here: Path = HERE) -> SimpleNamespace:
    """The cell ``name``'s entry and its configuration, traffic, limits,
    and the paths of its builder, driver and reference model, from the
    benchmark's folder ``here``."""
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = load_json(here / "configs" / f"{cell['config']}.json")
    traffic = load_json(here / "traffic" / f"{cell['traffic']}.json")
    return SimpleNamespace(
        cell=cell, config=config, traffic=traffic,
        builder=here / "configs" / f"{cell['config']}.py",
        driver=here / "drivers" / f"{traffic['algorithm']}.py",
        model=here / "reference" / "models" / f"{config['model']}.py",
        limits=load_json(here / "limits" / f"{name}.json"),
    )


def reader_path(here: Path, metric: str) -> Path:
    """The reader of ``metric``: ``metrics/<metric>.py``, else the reader
    of its family, ``metrics/<name before the first dot>.py``."""
    path = here / "metrics" / f"{metric}.py"
    return path if path.exists() else here / "metrics" / f"{metric.split('.')[0]}.py"


def drive(files: SimpleNamespace, seed: int, seconds: float, trace: bool, t_start: float,
          device, until_checked: bool = False):
    """Run the cell's driver once: returns ``(ctx, driver)``, ``ctx``
    holding what the run read and ``ctx.judge``."""
    tag = f"{files.cell['config']}_{files.traffic['algorithm']}"
    driver = load_module(files.driver, f"portbench_driver_{tag}")
    ctx = SimpleNamespace(
        seed=seed, seconds=seconds, trace=trace, t_start=t_start, device=device,
        cell=files.cell, config=files.config, traffic=files.traffic,
        builder=load_module(files.builder, f"portbench_config_{tag}"),
        reference=load_module(files.model, f"portbench_model_{tag}").build(files.config),
        until_checked=until_checked,
    )
    driver.run(ctx)
    return ctx, driver


def metrics_of(man: dict, cell_name: str, trace: bool) -> list:
    """The metric entries this cell reports in a run with or without the
    trace."""
    entries = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in entries if "workloads" not in m or cell_name in m["workloads"]]


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def power_limit_w():
    """The card's power limit in W (``nvidia-smi``, the first card), or
    None where it cannot be read."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0]) if out.returncode == 0 else None
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def require_card(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise Refused("torch.cuda.is_available() is False: the benchmark runs on a card only")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell asks for {chips} cards; {torch.cuda.device_count()} found")


def finite(v: float) -> float:
    """``v``, or the largest float where it is infinite or NaN (the result
    line is strict JSON)."""
    return v if math.isfinite(v) else sys.float_info.max


def judge(numbers: dict, limits: dict) -> tuple:
    """``(correct, checks, readings)``: correct where every number that
    has a limit is at or under it and no number is infinite or NaN (a
    step the check could not reach reads infinite). ``checks`` holds the
    compared numbers with their limits, ``readings`` the numbers without
    a limit (each cell's limits file names the numbers it compares)."""
    ok = all(math.isfinite(float(v)) for v in numbers.values())
    checks = {}
    for k, lim in sorted(limits.items()):
        v = float(numbers.get(k, math.inf))
        if lim is None or not v <= lim:
            ok = False
        checks[k] = {"value": finite(v), "limit": lim}
    readings = {k: finite(float(v)) for k, v in sorted(numbers.items()) if k not in limits}
    return ok, checks, readings


def parse(argv):
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run(argv, t_start: float, device: str = "cuda", root: Path = ROOT,
        until_checked: bool = False) -> dict:
    """One run: returns the result line's object. Raises :class:`Refused`
    where no result may be printed. ``device`` other than ``"cuda"`` skips
    the card's check, and ``until_checked`` closes the window once the
    judged steps have run (the CPU tests drive a run so)."""
    args = parse(argv)
    man = manifest(root)
    files = cell_files(man, args.workload, root / "portbench")
    if device == "cuda":
        require_card(int(files.cell["chips"]))
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    here = root / "portbench"
    ctx, _ = drive(files, args.seed, args.seconds, bool(args.trace), t_start,
                   torch.device(device), until_checked)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(ctx.device)
        kind = torch.cuda.get_device_name(ctx.device)
        watts = power_limit_w()
    else:
        peak, kind, watts = 0, "cpu", None
    numbers = ctx.judge()
    correct, checks, readings = judge(numbers, files.limits)
    metrics = {}
    for entry in metrics_of(man, args.workload, ctx.trace):
        name = entry["name"]
        reader = load_module(reader_path(here, name),
                             f"portbench_metric_{name.replace('.', '_')}")
        value = reader.read(ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": entry["unit"]}
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type, "kind": kind,
           "count": int(files.cell["chips"]), "memory_peak_bytes": int(peak),
           "power_limit_w": watts}
    out = {"correct": bool(correct), "attempted": int(ctx.steps), "failed": 0,
           "metrics": metrics, "device": dev}
    if ctx.trace:
        dev["busy_s"] = ctx.trace_summary.busy_s
        dev["window_s"] = ctx.trace_summary.window_s
        out["breakdown"] = {"device_ops": ctx.trace_summary.device_ops,
                            "idle_gaps": ctx.trace_summary.idle_gaps}
    out["readings"] = readings
    out["checks"] = checks
    # last, once the check and the readers have run in this process too
    found = forbidden_modules()
    if found:
        raise Refused(f"modules of JAX or of the JAX package are loaded: {found}")
    return out


def main(argv, t_start: float) -> int:
    try:
        out = run(argv, t_start)
    except Refused as err:
        print(f"portbench: no result: {err}", file=sys.stderr, flush=True)
        return 2
    dev = out["device"]
    print(f"device {dev['kind']} power limit {dev['power_limit_w']!r} W", file=sys.stderr)
    for k, v in out["readings"].items():
        print(f"reading {k} {v!r} (not compared)", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:], time.perf_counter()))
