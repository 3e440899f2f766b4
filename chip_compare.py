#!/usr/bin/env python3
"""The main paths of two checkouts, in turns, on one CUDA card.

    python3 chip_compare.py BEFORE_DIR AFTER_DIR    # runs before, after, after, before
    python3 chip_compare.py BEFORE_DIR AFTER_DIR --oscillator    # its first three parts only
    python3 chip_compare.py BEFORE_DIR AFTER_DIR --oscillator --rounds 5    # that order 5 times
    python3 chip_compare.py BEFORE_DIR AFTER_DIR --vehicle-apf --rounds 5    # the vehicle APF only
    python3 chip_compare.py BEFORE_DIR AFTER_DIR --reuse    # the factor-reuse paths

Each run is a child process in one checkout (it builds that checkout's
kernels) that calls that checkout's ``chip_smoke.py`` phase functions: the
oscillator online APF at 32768 particles x 749 steps (phase 10), the toy
and oscillator Gibbs samplers at 200 particles (phase 12, 11 toy and 4
oscillator sweeps) and the profile of the oscillator cSMC step (phase
13), and the resampler wrapper's host time per call at 200 particles
(200 calls queued without waiting for the card, median of 10); then the
vehicle (the resampler's host time again at 32768): its online APF at 32768 particles x 1499 steps
(phase 4's body), its Gibbs sampler at 10240 particles x 1499 steps (a
warm-up and two timed sweeps, phase 6), the profile of 100 cSMC steps
(phase 7) and of 50 online APF steps (written out below on the APF's
public ``init`` / ``draws`` / ``step``, so that a checkout without
``profile_apf_steps`` runs it too). The APF prints its RMSE and ESS in
full, so that two checkouts whose kernels agree bit for bit print the
same digits. With ``--oscillator`` each run ends after the oscillator's
three parts, and with ``--vehicle-apf`` each runs the vehicle's online
APF, the resampler's host time and the APF steps' profile only. With
``--reuse`` each runs the opt-in factor-reuse configuration
(``reuse_factor=True``): the vehicle's online APF at 32768 x 1499 with
it, then 50 profiled APF steps and 100 profiled cSMC steps at 10240
particles, each first in the default configuration and then with reuse
(the figures' values 1 and 2), all through the public ``build_*``
keywords, so that the parent runs them too. With ``--rounds R`` the
order before, after, after, before runs R times. Output lines are
printed with the run's label; at the end, for each figure every run
prints (the APF's seconds, the medians of the sweeps, the cSMC and APF
steps' device and unprofiled time and idle share, the resampler's host
time), its values in run order and in how many of the adjacent before /
after pairs the after run read higher; then the card's name and power
limit. Two versions compare only within one such call. A failed
run, or no card, ends the script with a non-zero exit.
"""

import argparse
import os
import re
import subprocess
import sys

RUN = r"""
import os, sys, time
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
from bipk_tpu_torch.models import vehicle as veh
from bipk_tpu_torch.ops import _build
from bipk_tpu_torch.ops import cuda_kernels as ck
from bipk_tpu_torch.parallel.sharded import build_sharded_apf

dev = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = False
tb = time.perf_counter()
_build.build()
ck._lib()
print(f"  build {time.perf_counter() - tb:.2f} s", flush=True)
smi, part = sys.argv[1], sys.argv[2]
reuse = dict(reuse_factor=True) if part == "--reuse" else {}


def resampler_host_time(n):
    w_r = torch.softmax(torch.randn((n,), device=dev), 0)
    u_r = torch.rand((1,), device=dev)
    host = []
    for _ in range(11):
        torch.cuda.synchronize()
        th = time.perf_counter()
        for _ in range(200):
            ck.systematic_ancestors_blocks(w_r, u_r, n)
        host.append((time.perf_counter() - th) / 200 * 1e6)
    torch.cuda.synchronize()
    print(f"  resampler wrapper host time at {n} particles: {sorted(host[1:])[5]:.2f} us per "
          "call", flush=True)


if part == "all" or part == "--oscillator":
    models = cs.cs_models(dev)
    model, X, Y, U, (F,) = models["osc"]
    cs.osc_main_path(dev, model, X, Y, F, U, smi)
    cs.cs_gibbs_paths(dev, models, toy_iterations=11, osc_iterations=4, smi=smi)
    cs.profile_csmc_steps(dev, model, Y, U, X, (F,), cs.N_CS_GIBBS, steps=100)
    resampler_host_time(cs.N_CS_GIBBS)
if part == "--oscillator":
    sys.exit(0)

# the vehicle
cfg = veh.VehicleConfig(t_end=1500 * 0.02, forgetting_factor=cs.LAM)
model = veh.make_model(cfg)
X, Y, MU_F, MU_R, U = veh.simulate(torch.Generator().manual_seed(cfg.seed), cfg,
                                   dtype=torch.float32, device=dev)
apf = build_sharded_apf(model.ssm, model.gps, cs.N, forgetting_factor=cs.LAM,
                        dtype=torch.float32, device=dev, **reuse)
apf(torch.Generator(device=dev).manual_seed(2), Y[:11], U[:11], model.x0, model.p0)
torch.cuda.synchronize()
steps = Y.shape[0] - 1
ck.reset_launch_counts()
ts = time.perf_counter()
res = apf(torch.Generator(device=dev).manual_seed(3), Y, U, model.x0, model.p0)
torch.cuda.synchronize()
elapsed = time.perf_counter() - ts
print(f"  vehicle APF launches { {k: c for k, c in ck.launch_counts().items() if c} }", flush=True)
ess = res.ess[1:]
print(f"  vehicle APF {cs.N} particles x {steps} steps in {elapsed:.3f} s"
      f"{' with reuse' * bool(reuse)}: "
      f"{cs.N * steps / elapsed:.1f} particle-steps/s on {smi}", flush=True)
print(f"  vehicle APF ESS min {ess.min().item()!r} median {ess.median().item()!r} max "
      f"{ess.max().item()!r}; filtered-state RMSE "
      f"{[repr(x) for x in ((res.state_mean - X) ** 2).mean(0).sqrt().tolist()]}", flush=True)
resampler_host_time(cs.N)
refs = (MU_F[:, None], MU_R[:, None])
if part == "all":
    cs.gibbs_path(dev, model, X, Y, U, MU_F, cs.N_GIBBS, n_apf=256, n_iterations=4, smi=smi)
    cs.profile_csmc_steps(dev, model, Y, U, X, refs, cs.N_GIBBS, steps=100)

# 50 vehicle APF steps from one pinned carry: under CUDA's sync debug mode
# "error", on the host's clock, and under torch.profiler
from torch.profiler import ProfilerActivity, profile
P = 50


def profile_apf(apf, label):
    g = torch.Generator(device=dev).manual_seed(8)
    apf(g, Y[:P + 1], U[:P + 1], model.x0, model.p0)
    obs = Y.reshape(Y.shape[0], -1)
    carry0 = apf.init(g, U[0], model.x0, model.p0)

    def run_steps():
        carry = carry0
        for t in range(P):
            carry, _ = apf.step(carry, obs[t + 1], U[t], U[t + 1], apf.draws(g))
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run_steps()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    tw = time.perf_counter()
    run_steps()
    step_us = (time.perf_counter() - tw) / P * 1e6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_steps()
    on_device = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in on_device) / P
    ours = sum(e.self_device_time_total for e in on_device
               if any(k in e.key for k in cs.OUR_KERNELS)) / P
    print(f"  APF step at {cs.N} particles ({P} steps profiled, no host synchronisation"
          f"{label}): device busy {busy_us:.1f} us per step over "
          f"{sum(e.count for e in on_device) / P:.1f} device launches, of which the "
          f"hand-written kernels {ours:.1f} us; the same steps unprofiled {step_us:.1f} us per "
          f"step, device idle share {1.0 - busy_us / step_us:.3f}", flush=True)
    for e in sorted(on_device, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {e.self_device_time_total / P:8.1f} us/step  {e.count / P:5.1f}/step  "
              f"{e.key[:90]}", flush=True)


if part == "--reuse":
    # the default configuration first, then reuse: values 1 and 2 of each
    # figure below
    default_apf = build_sharded_apf(model.ssm, model.gps, cs.N, forgetting_factor=cs.LAM,
                                    dtype=torch.float32, device=dev)
    profile_apf(default_apf, ", default")
    profile_apf(apf, ", reuse_factor=True")
    for label, options in (("default", {}), ("reuse_factor=True", reuse)):
        print(f"  cSMC steps, {label}:", flush=True)
        cs.profile_csmc_steps(dev, model, Y, U, X, refs, cs.N_GIBBS, steps=100, **options)
else:
    profile_apf(apf, "")
"""


# the figures summed up at the end: name, and a pattern of one number
FIGURES = (
    ("APF s", r"^\s*(?:vehicle APF )?32768 particles x \d+ steps in ([\d.]+) s"),
    ("toy sweep s (median)", r"200 particles x 39 steps: .* median ([\d.]+)"),
    ("osc sweep s (median)", r"200 particles x 749 steps: .* median ([\d.]+)"),
    ("vehicle sweep s (median)", r"10240 particles x 1499 steps: .* median ([\d.]+)"),
    ("cSMC step busy us", r"cSMC step at \d+ particles .* device busy ([\d.]+) us"),
    ("cSMC step unprofiled us", r"cSMC step at \d+ particles .* unprofiled ([\d.]+) us"),
    ("APF step busy us", r"APF step at \d+ particles .* device busy ([\d.]+) us"),
    ("APF step unprofiled us", r"APF step at \d+ particles .* unprofiled ([\d.]+) us"),
    ("cSMC step idle share", r"cSMC step at \d+ particles .* idle share ([\d.]+)"),
    ("APF step idle share", r"APF step at \d+ particles .* idle share ([\d.]+)"),
    ("resampler host us per call", r"resampler wrapper host time .*: ([\d.]+) us"),
)


def summary(runs):
    """For each figure, its values in run order (a run may print several,
    the oscillator's before the vehicle's) and, for each of them, the
    adjacent before / after pairs in which the after run's is the
    higher."""
    for name, pattern in FIGURES:
        rows = [(label, [float(m.group(1)) for line in out
                         if (m := re.search(pattern, line))]) for label, out in runs]
        if not all(v for _, v in rows):
            continue
        print(f"{name}: " + "; ".join(f"{label[0]} {', '.join(map(str, v))}"
                                      for label, v in rows), flush=True)
        pairs = [dict(rows[k:k + 2]) for k in range(0, len(rows) - 1, 2)]
        for j in range(min(len(v) for _, v in rows)):
            higher = sum(p["after"][j] > p["before"][j] for p in pairs)
            print(f"  value {j + 1}: after higher in {higher} of {len(pairs)} before / after "
                  "pairs", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("before")
    parser.add_argument("after")
    only = parser.add_mutually_exclusive_group()
    only.add_argument("--oscillator", action="store_true")
    only.add_argument("--vehicle-apf", action="store_true")
    only.add_argument("--reuse", action="store_true")
    parser.add_argument("--rounds", type=int, default=1)
    args = parser.parse_args()
    before, after = os.path.abspath(args.before), os.path.abspath(args.after)
    part = next((flag for flag, on in (("--oscillator", args.oscillator),
                                        ("--vehicle-apf", args.vehicle_apf),
                                        ("--reuse", args.reuse)) if on), "all")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    runs = []
    for label, root in (("before", before), ("after", after), ("after", after),
                        ("before", before)) * args.rounds:
        print(f"== {label}: {root}", flush=True)
        proc = subprocess.run([sys.executable, "-c", RUN, smi, part], cwd=root,
                              text=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              timeout=1200)
        for line in proc.stdout.splitlines():
            print(f"[{label}] {line}", flush=True)
        if proc.returncode != 0:
            print(f"chip_compare: the {label} run failed (exit {proc.returncode})",
                  file=sys.stderr)
            return 1
        runs.append((label, proc.stdout.splitlines()))
    summary(runs)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
