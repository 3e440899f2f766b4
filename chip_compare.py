#!/usr/bin/env python3
"""The m <= 48 main paths of two checkouts, in turns, on one CUDA card.

    python3 chip_compare.py BEFORE_DIR AFTER_DIR    # runs before, after, after, before

Each run is a child process in one checkout (it builds that checkout's
kernels) that calls that checkout's ``chip_smoke.py`` phase functions: the
oscillator online APF at 32768 particles x 749 steps (phase 10), the toy
and oscillator Gibbs samplers at 200 particles (phase 12, 11 toy and 4
oscillator sweeps) and the profile of the oscillator cSMC step (phase 13).
Their output lines are printed with the run's label, followed by the card's
name and power limit. Two versions compare only within one such call. A
failed run, or no card, ends the script with a non-zero exit.
"""

import os
import subprocess
import sys

RUN = r"""
import os, sys, time
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
from bipk_tpu_torch.ops import _build
from bipk_tpu_torch.ops import cuda_kernels as ck

dev = torch.device("cuda")
tb = time.perf_counter()
_build.build()
ck._lib()
print(f"  build {time.perf_counter() - tb:.2f} s", flush=True)
smi = sys.argv[1]
models = cs.cs_models(dev)
model, X, Y, U, (F,) = models["osc"]
cs.osc_main_path(dev, model, X, Y, F, U, smi)
cs.cs_gibbs_paths(dev, models, toy_iterations=11, osc_iterations=4, smi=smi)
cs.profile_csmc_steps(dev, model, Y, U, X, (F,), cs.N_CS_GIBBS, steps=100)
"""


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    before, after = (os.path.abspath(d) for d in sys.argv[1:])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    for label, root in (("before", before), ("after", after), ("after", after),
                        ("before", before)):
        print(f"== {label}: {root}", flush=True)
        proc = subprocess.run([sys.executable, "-c", RUN, smi], cwd=root, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=900)
        for line in proc.stdout.splitlines():
            print(f"[{label}] {line}", flush=True)
        if proc.returncode != 0:
            print(f"chip_compare: the {label} run failed (exit {proc.returncode})",
                  file=sys.stderr)
            return 1
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
