"""Vehicle experiment: front and rear tire-friction
identification, the port of ``scripts/vehicle.py``.

    python -m bipk_tpu_torch.scripts.vehicle                      # 200 particles, 800 sweeps
    python -m bipk_tpu_torch.scripts.vehicle --quick --cpu
    python -m bipk_tpu_torch.scripts.vehicle --profile plots/vehicle_trace
    torchrun --nproc-per-node=4 -m bipk_tpu_torch.scripts.vehicle --mesh 4 --chains 4

Simulated data from the true (Pacejka) friction curves, the online APF
with its two GPs (m = 20 each), the Gibbs sampler (Algorithm 2) seeded by
an APF reference, and a ``.mat`` file with the JAX script's keys (those of
the reference's ``VehicleSimulation_Simulation.py``). With ``--chains C``
the Gibbs sampler runs C chains, each from its own reference trajectory;
both frictions' R-hat and bulk ESS are printed and chain 0 goes into the
file. ``--checkpoint PATH`` saves the chain every ``--checkpoint-every``
sweeps and resumes it from an existing file, bit for bit. ``--mesh N``
runs the Gibbs sampler on the N ranks of a process group (torchrun's, or
on one rank without one): with ``--chains`` the chain mesh, otherwise the
particle-sharded cSMC; only rank 0 prints the Gibbs summary and writes
the file. ``--profile
DIR`` runs the online sweep once to warm up (its draws replayed, so the
results do not change) and then under ``torch.profiler``, writing a
Chrome trace to ``DIR/trace.json``. Runs on CUDA unless ``--cpu`` is
given; one ``torch.Generator`` seeded with the configuration's seed draws
every random number (the simulated data from a CPU generator seeded by
its first draw).
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
from bipk_tpu_torch.models import vehicle as veh
from bipk_tpu_torch.scripts import common
from bipk_tpu_torch.utils import matio
from bipk_tpu_torch.utils.profiling import block, profile_trace

# the keys of the .mat file that run() writes, as the JAX package's
# scripts/vehicle.py writes them (:180-205)
MAT_KEYS = frozenset({
    *(f"{p}_{k}" for p in ("offline", "online")
      for k in ("Sigma_X", "Sigma_Y", "weights", "log_likelihood", "T0_f", "T1_f", "T2_f",
                "T3_f", "T0_r", "T1_r", "T2_r", "T3_r", "Sigma_mu_f", "Sigma_mu_r",
                "Sigma_alpha_f", "Sigma_alpha_r")),
    *(f"prior_T{i}_{s}" for i in range(4) for s in ("f", "r")),
    "time", "alpha_plot", "basis_plot", "mu_true_plot", "X", "Y", "mu_f", "mu_r",
})


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--particles", type=int, default=200)
    p.add_argument("--gibbs-iters", type=int, default=800)
    p.add_argument("--t-end", type=float, default=30.0)
    p.add_argument("--quick", action="store_true")
    p.add_argument("--f64", action="store_true")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (the plain versions)")
    common.add_gibbs_flags(p)
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the online sweep into DIR "
                        "(after a warm-up sweep)")
    p.add_argument("--out", default="plots/Vehicle_torch.mat")
    args = p.parse_args(argv)
    common.check_gibbs_flags(args)
    if args.quick:
        args.particles, args.gibbs_iters, args.t_end = 50, 20, 2.0
    return args


def side_slip_traces(states: torch.Tensor, inputs: torch.Tensor):
    """Front and rear side-slip angles ``(T, K)`` of trajectories ``states
    (T, K, 2)`` under ``inputs (T, 2)``."""
    return veh.side_slip(states.permute(2, 0, 1), inputs.T[:, :, None])


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
    cfg = veh.VehicleConfig(n_particles=args.particles, n_gibbs=args.gibbs_iters,
                            t_end=args.t_end)
    model = veh.make_model(cfg)
    g = torch.Generator(device=device).manual_seed(cfg.seed)
    X, Y, mu_f, mu_r, inputs = veh.simulate(common.simulation_generator(g), cfg, dtype=dtype,
                                            device=device)
    time = np.arange(0.0, cfg.t_end, cfg.dt)
    hook("model", model=model, data=(X, Y, mu_f, mu_r, inputs))

    print("=== Online Algorithm ===")
    apf = build_apf(model.ssm, model.gps, cfg.n_particles, cfg.forgetting_factor,
                    dtype=dtype, device=device)
    if args.profile:  # warm up outside the trace, then replay the same draws
        state = g.get_state()
        block(apf(g, Y, inputs, model.x0, model.p0))
        g.set_state(state)
    t0 = timelib.perf_counter()
    with profile_trace(args.profile if common.lead_rank() else None):
        online = block(apf(g, Y, inputs, model.x0, model.p0))
    hook("online", result=online)
    print(f"online sweep: {timelib.perf_counter() - t0:.2f}s")
    online_alpha_f, online_alpha_r = side_slip_traces(online.states, inputs)

    print("=== Offline Algorithm ===")
    ref_run = apf(g, Y, inputs, model.x0, model.p0)
    ref_state, ref_iv = common.reference_trajectories(g, ref_run, n_chains)
    del ref_run
    hook("reference")
    gibbs = build_gibbs(model.ssm, model.gps, cfg.n_particles, cfg.n_gibbs, dtype=dtype,
                        fused=False, device=device, shard_mesh=shard_mesh,
                        n_chains=n_chains if n_chains > 1 else None, chain_mesh=chain_mesh)
    offline = common.offline_gibbs(gibbs, g, Y, inputs, model, ref_state, ref_iv, args,
                                   ("mu_f", "mu_r"), hook)
    offline_alpha_f, offline_alpha_r = side_slip_traces(offline.states, inputs)

    # the plotting grids of the reference's VehicleSimulation_Simulation.py
    alpha_plot = np.linspace(-20 / 180 * np.pi, 20 / 180 * np.pi, 500)
    alpha_t = torch.as_tensor(alpha_plot, dtype=dtype, device=device)
    mdict = {
        **matio.offline_entries("offline", offline, gp_index=0, suffix="_f"),
        **matio.offline_entries("offline", offline, gp_index=1, suffix="_r"),
        "offline_Sigma_mu_f": offline.int_vars[0],
        "offline_Sigma_mu_r": offline.int_vars[1],
        "offline_Sigma_alpha_f": offline_alpha_f,
        "offline_Sigma_alpha_r": offline_alpha_r,
        **matio.online_entries("online", online, gp_index=0, suffix="_f"),
        **matio.online_entries("online", online, gp_index=1, suffix="_r"),
        "online_Sigma_mu_f": online.int_vars[0],
        "online_Sigma_mu_r": online.int_vars[1],
        "online_Sigma_alpha_f": online_alpha_f,
        "online_Sigma_alpha_r": online_alpha_r,
        **matio.prior_entries(model.gps[0].prior, suffix="_f"),
        **matio.prior_entries(model.gps[1].prior, suffix="_r"),
        "time": time,
        "alpha_plot": alpha_plot,
        "basis_plot": model.basis.eigen_fn_bl(alpha_t).T,
        "mu_true_plot": veh.mu_y_true(alpha_t),
        "X": X,
        "Y": Y,
        "mu_f": mu_f,
        "mu_r": mu_r,
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
