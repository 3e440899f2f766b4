#!/usr/bin/env python3
"""The main paths of two checkouts, in turns, on one CUDA card.

    python3 chip_compare.py BEFORE_DIR AFTER_DIR    # runs before, after, after, before

Each run is a child process in one checkout (it builds that checkout's
kernels) that calls that checkout's ``chip_smoke.py`` phase functions: the
oscillator online APF at 32768 particles x 749 steps (phase 10), the toy
and oscillator Gibbs samplers at 200 particles (phase 12, 11 toy and 4
oscillator sweeps) and the profile of the oscillator cSMC step (phase
13); then the vehicle: its online APF at 32768 particles x 1499 steps
(phase 4's body), its Gibbs sampler at 10240 particles x 1499 steps (a
warm-up and two timed sweeps, phase 6), the profile of 100 cSMC steps
(phase 7) and of 50 online APF steps (written out below on the APF's
public ``init`` / ``draws`` / ``step``, so that a checkout without
``profile_apf_steps`` runs it too). The APF prints its RMSE and ESS in
full, so that two checkouts whose kernels agree bit for bit print the
same digits. Output lines are printed with the run's label, followed by
the card's name and power limit. Two versions compare only within one
such call. A failed run, or no card, ends the script with a non-zero
exit.
"""

import os
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
smi = sys.argv[1]
models = cs.cs_models(dev)
model, X, Y, U, (F,) = models["osc"]
cs.osc_main_path(dev, model, X, Y, F, U, smi)
cs.cs_gibbs_paths(dev, models, toy_iterations=11, osc_iterations=4, smi=smi)
cs.profile_csmc_steps(dev, model, Y, U, X, (F,), cs.N_CS_GIBBS, steps=100)

# the vehicle
cfg = veh.VehicleConfig(t_end=1500 * 0.02, forgetting_factor=cs.LAM)
model = veh.make_model(cfg)
X, Y, MU_F, MU_R, U = veh.simulate(torch.Generator().manual_seed(cfg.seed), cfg,
                                   dtype=torch.float32, device=dev)
apf = build_sharded_apf(model.ssm, model.gps, cs.N, forgetting_factor=cs.LAM,
                        dtype=torch.float32, device=dev)
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
print(f"  vehicle APF {cs.N} particles x {steps} steps in {elapsed:.3f} s: "
      f"{cs.N * steps / elapsed:.1f} particle-steps/s on {smi}", flush=True)
print(f"  vehicle APF ESS min {ess.min().item()!r} median {ess.median().item()!r} max "
      f"{ess.max().item()!r}; filtered-state RMSE "
      f"{[repr(x) for x in ((res.state_mean - X) ** 2).mean(0).sqrt().tolist()]}", flush=True)
cs.gibbs_path(dev, model, X, Y, U, MU_F, cs.N_GIBBS, n_apf=256, n_iterations=4, smi=smi)
cs.profile_csmc_steps(dev, model, Y, U, X, (MU_F[:, None], MU_R[:, None]), cs.N_GIBBS,
                      steps=100)

# 50 vehicle APF steps from one pinned carry: under CUDA's sync debug mode
# "error", on the host's clock, and under torch.profiler
from torch.profiler import ProfilerActivity, profile
P = 50
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
             if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
busy_us = sum(e.self_device_time_total for e in on_device) / P
ours = sum(e.self_device_time_total for e in on_device
           if any(k in e.key for k in cs.OUR_KERNELS)) / P
print(f"  APF step at {cs.N} particles ({P} steps profiled, no host synchronisation): "
      f"device busy {busy_us:.1f} us per step over "
      f"{sum(e.count for e in on_device) / P:.1f} device launches, of which the hand-written "
      f"kernels {ours:.1f} us; the same steps unprofiled {step_us:.1f} us per step, device "
      f"idle share {1.0 - busy_us / step_us:.3f}", flush=True)
for e in sorted(on_device, key=lambda e: -e.self_device_time_total)[:8]:
    print(f"    {e.self_device_time_total / P:8.1f} us/step  {e.count / P:5.1f}/step  "
          f"{e.key[:90]}", flush=True)
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
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=1200)
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
