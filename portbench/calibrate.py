"""The readings that a cell's limits are set from, on the card: the
check's numbers of the program over many seeds, and of the control (the
reference in float32 with TF32 operands in every product, put in the
program's place at the judged steps) and of any fault the driver reads
(``resample`` under resamplers at fault, in the APF) over some of them, in
one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 11 12 ... --control 3

Each seed runs the cell's workload at its own size only as far as its
check needs (the APF to its last checked step, one Gibbs sweep) and
judges it. Prints one JSON line per seed and a summary: per number the
largest program reading, the smallest control reading, their ratio, and
the smallest reading of each fault of that number.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def main(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3, help="seeds (the first ones) of the control")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    man = harness.manifest()
    files = harness.cell_files(man, args.workload)
    harness.require_card(int(files.cell["chips"]))
    torch.backends.cuda.matmul.allow_tf32 = False
    program, control, faults = {}, {}, {}
    out = open(args.out, "w") if args.out else None
    for n, seed in enumerate(args.seeds):
        t = time.perf_counter()
        ctx, driver = harness.drive(files, seed, 1e9, False, t, torch.device("cuda"),
                                    until_checked=True)
        prog, ctrl, fault = driver.readings(ctx, n < args.control)
        line = {"seed": seed, "program": prog}
        if ctrl:
            line["control"] = ctrl
        if fault:
            line["faults"] = fault
        line["seconds"] = time.perf_counter() - t
        for into, got in ((program, prog), (control, ctrl), (faults, fault)):
            for k, v in got.items():
                into.setdefault(k, []).append(v)
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
        del ctx
        torch.cuda.empty_cache()
    summary = {}
    for k, vals in program.items():
        lo = max(vals)
        up = min(control[k]) if k in control else None
        summary[k] = {"lower": lo, "upper": up,
                      "ratio": (up / lo if up is not None and lo > 0 else
                                (math.inf if up else None))}
        for f, got in faults.items():
            if f.split(".")[0] == k:
                summary[k][f"fault.{f.split('.', 1)[1]}"] = min(got)
    print(json.dumps({"summary": summary}), flush=True)
    if out:
        out.write(json.dumps({"summary": summary}) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
