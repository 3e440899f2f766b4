"""Single-mass-oscillator experiment: online APF and offline
Gibbs sampler, the port of ``scripts/single_mass_oscillator.py``.

    python -m bipk_tpu_torch.scripts.single_mass_oscillator        # 200 particles, 800 sweeps
    python -m bipk_tpu_torch.scripts.single_mass_oscillator --quick --cpu
    python -m bipk_tpu_torch.scripts.single_mass_oscillator --checkpoint plots/smo.ckpt

Simulated data from the true spring and damper forces, the online APF,
the Gibbs sampler (Algorithm 2) seeded by an APF reference, and a ``.mat``
file with the JAX script's keys (those of the reference's
``SingleMassOscillator_Simulation.py``). With ``--chains C`` the Gibbs
sampler runs C chains, each from its own reference trajectory; the
force's R-hat and bulk ESS are printed and chain 0 goes into the file.
``--checkpoint PATH`` saves the chain every ``--checkpoint-every`` sweeps
and resumes it from an existing file, bit for bit. ``--mesh N`` runs the Gibbs
sampler on the N ranks of a process group (torchrun's, or on one rank
without one): with ``--chains`` the chain mesh, otherwise the
particle-sharded cSMC; only rank 0 prints the Gibbs summary and writes
the file. Runs on CUDA unless
``--cpu`` is given; one ``torch.Generator`` seeded with the
configuration's seed draws every random number (the simulated data from a
CPU generator seeded by its first draw).
"""

from __future__ import annotations

import argparse
import sys
import time as timelib
from typing import Callable

import numpy as np
import torch

from bipk_tpu_torch._device import resolve_device
from bipk_tpu_torch.algorithms import build_apf, build_gibbs
from bipk_tpu_torch.models import oscillator as smo
from bipk_tpu_torch.scripts import common
from bipk_tpu_torch.utils import matio

# the keys of the .mat file that run() writes, as the JAX package's
# scripts/single_mass_oscillator.py writes them (:166-180)
MAT_KEYS = frozenset({
    *(f"{p}_{k}" for p in ("offline", "online")
      for k in ("Sigma_X", "Sigma_Y", "weights", "log_likelihood", "T0", "T1", "T2", "T3",
                "Sigma_F")),
    "prior_T0", "prior_T1", "prior_T2", "prior_T3", "time", "X_plot", "basis_plot",
    "F_sd_true_plot", "X", "Y", "F_sd",
})


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--particles", type=int, default=200)
    p.add_argument("--gibbs-iters", type=int, default=800)
    p.add_argument("--t-end", type=float, default=15.0)
    p.add_argument("--quick", action="store_true", help="tiny smoke configuration")
    p.add_argument("--f64", action="store_true")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (the plain versions)")
    common.add_gibbs_flags(p)
    p.add_argument("--plot-grid", type=int, default=50,
                   help="points per axis of the X_plot evaluation grid")
    p.add_argument("--out", default="plots/SingleMassOscillator_torch.mat")
    args = p.parse_args(argv)
    common.check_gibbs_flags(args)
    if args.quick:
        args.particles, args.gibbs_iters, args.t_end = 50, 20, 2.0
    return args


def run(args: argparse.Namespace, hook: Callable | None = None) -> dict:
    """The experiment; returns the ``.mat`` dictionary it wrote.
    ``hook(event, **info)``, if given, runs after each part: ``"model"``,
    ``"online"``, ``"reference"``, ``"gibbs-sweep"`` (``k``), ``"gibbs"``."""
    hook = hook or (lambda event, **info: None)
    device = resolve_device("cpu" if args.cpu else "cuda")
    n_chains = max(1, args.chains)
    # before anything is made on the device: torchrun's NCCL group binds the card
    shard_mesh, chain_mesh = common.gibbs_meshes(args, n_chains, device)
    dtype = torch.float64 if args.f64 else torch.float32
    cfg = smo.OscillatorConfig(n_particles=args.particles, n_gibbs=args.gibbs_iters,
                               t_end=args.t_end)
    model = smo.make_model(cfg)
    g = torch.Generator(device=device).manual_seed(cfg.seed)
    X, Y, F_sd, inputs = smo.simulate(common.simulation_generator(g), cfg, dtype=dtype,
                                      device=device)
    time = np.arange(0.0, cfg.t_end, cfg.dt)
    hook("model", model=model, data=(X, Y, F_sd, inputs))

    print("=== Online Algorithm ===")
    apf = build_apf(model.ssm, model.gps, cfg.n_particles, cfg.forgetting_factor,
                    dtype=dtype, device=device)
    t0 = timelib.perf_counter()
    online = apf(g, Y, inputs, model.x0, model.p0)
    hook("online", result=online)
    print(f"online sweep: {timelib.perf_counter() - t0:.2f}s")

    print("=== Offline Algorithm ===")
    ref_run = apf(g, Y, inputs, model.x0, model.p0)
    ref_state, ref_iv = common.reference_trajectories(g, ref_run, n_chains)
    del ref_run
    hook("reference")
    gibbs = build_gibbs(model.ssm, model.gps, cfg.n_particles, cfg.n_gibbs, dtype=dtype,
                        fused=False, device=device, shard_mesh=shard_mesh,
                        n_chains=n_chains if n_chains > 1 else None, chain_mesh=chain_mesh)
    offline = common.offline_gibbs(gibbs, g, Y, inputs, model, ref_state, ref_iv, args,
                                   ("F_sd",), hook)

    # the plotting grid of the reference's SingleMassOscillator_Simulation.py
    axis = np.linspace(-3.5, 3.5, args.plot_grid)
    grid_x, grid_y = np.meshgrid(axis, axis, indexing="xy")
    X_plot = np.vstack([grid_x.flatten(), grid_y.flatten()]).T
    X_plot_t = torch.as_tensor(X_plot, dtype=dtype, device=device)
    mdict = {
        **matio.offline_entries("offline", offline),
        "offline_Sigma_F": offline.int_vars[0],
        **matio.online_entries("online", online),
        "online_Sigma_F": online.int_vars[0],
        **matio.prior_entries(model.gp.prior),
        "time": time,
        "X_plot": X_plot,
        "basis_plot": model.basis.eigen_fn_bl(X_plot_t.T).T,
        "F_sd_true_plot": smo.spring_force(X_plot_t[:, 0]) + smo.damper_force(X_plot_t[:, 1]),
        "X": X,
        "Y": Y[:, 0],
        "F_sd": F_sd[:, 0],
    }
    if common.lead_rank():
        matio.save_mat(args.out, mdict)
        print(f"saved {args.out}")
    return mdict


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
