"""EMPS experiment: friction identification on (real or
surrogate) data, the port of ``scripts/emps.py``'s default configuration.

    python -m bipk_tpu_torch.scripts.emps                 # 200 particles, 800 sweeps
    python -m bipk_tpu_torch.scripts.emps --quick --cpu   # a small run on the CPU
    python -m bipk_tpu_torch.scripts.emps --chains 4      # four Gibbs chains, R-hat and ESS
    python -m bipk_tpu_torch.scripts.emps --checkpoint plots/emps.ckpt   # resumes if it exists

The online APF, the offline Gibbs sampler seeded by an APF reference, the
posterior mean over its sweeps, the classic-PGAS baseline with the
729-function full-transition basis (its trajectory statistics summed as
running sums), the validation RMSE of both on the pulse dataset, and a
``.mat`` file with the JAX script's keys. With ``--chains C`` the Gibbs
sampler runs C chains, each from its own reference trajectory of the one
reference APF run; the friction's split R-hat and bulk ESS over the
second half of the sweeps are printed, and chain 0 goes into the ``.mat``
file. ``--checkpoint PATH`` saves the Gibbs chain every
``--checkpoint-every`` sweeps and resumes it from an existing file, bit
for bit. ``--mesh N`` runs the Gibbs sampler on the N ranks of a process
group (torchrun's, or on one rank without one): with ``--chains`` the
chain mesh, otherwise the particle-sharded cSMC; only rank 0 prints the
Gibbs summary and writes the file. Runs on CUDA unless ``--cpu`` is given; one ``torch.Generator``
seeded with the configuration's seed draws every random number.
"""

from __future__ import annotations

import argparse
import sys
import time as timelib
from typing import Callable

import numpy as np
import torch

from bipk_tpu_torch._device import resolve_device
from bipk_tpu_torch.algorithms import build_apf, build_gibbs, build_pgas
from bipk_tpu_torch.algorithms.pgas import PGAS
from bipk_tpu_torch.models import emps
from bipk_tpu_torch.ops import mniw
from bipk_tpu_torch.ops.gaussian import mvn_logpdf_chol
from bipk_tpu_torch.scripts import common
from bipk_tpu_torch.utils import matio

# the keys of the .mat file that run() writes, as the JAX package's
# scripts/emps.py writes them (:180-189, :261-275); --skip-baseline leaves
# out the four of the classic-PGAS baseline
MAT_KEYS = frozenset({
    *(f"{p}_{k}" for p in ("offline", "online")
      for k in ("Sigma_X", "Sigma_Y", "weights", "log_likelihood", "T0", "T1", "T2", "T3",
                "Sigma_F")),
    "prior_T0", "prior_T1", "prior_T2", "prior_T3", "time", "Y", "X",
    "offline_Sigma_X_PGAS", "offline_log_likelihood_PGAS", "RMSE_Alg2", "RMSE_PGAS",
    "dq_plot", "basis_plot",
})


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--particles", type=int, default=200)
    p.add_argument("--gibbs-iters", type=int, default=800)
    p.add_argument("--pgas-iters", type=int, default=None, help="default 3x gibbs")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--f64", action="store_true")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (the plain versions)")
    p.add_argument("--data-dir", default="data")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--skip-baseline", action="store_true")
    common.add_gibbs_flags(p)
    p.add_argument("--out", default="plots/EMPS_torch.mat")
    args = p.parse_args(argv)
    common.check_gibbs_flags(args)
    if args.quick:
        args.particles, args.gibbs_iters, args.max_steps = 50, 10, 150
        args.pgas_iters = 10
    if args.pgas_iters is None:
        args.pgas_iters = 3 * args.gibbs_iters
    return args


def baseline_pgas(model: emps.EMPSModel, n_particles: int, n_iterations: int, dtype,
                  device) -> PGAS:
    """The classic-PGAS baseline: the full two-dimensional transition on
    the 729-function basis, the position observed with the model's
    output noise."""
    out_chol = model.ssm.output_chol(dtype, device)
    return build_pgas(
        basis_fn=model.baseline_basis_fn,
        likelihood_fn=lambda obs, x, u: mvn_logpdf_chol(obs, x[:1], out_chol),
        prior=model.baseline_prior, n_particles=n_particles, n_iterations=n_iterations,
        dtype=dtype, fused=False, device=device,
    )


def baseline_posterior_mean(model: emps.EMPSModel, states, inputs) -> torch.Tensor:
    """The baseline's posterior coefficient mean ``(2, 729)`` from the
    trajectory statistics averaged over its draws ``states (T, K, 2)``,
    summed as running sums, one draw at a time (a ``(T, 729, 729)`` stack
    of outer products would not fit)."""
    K = states.shape[1]
    prior = mniw.MNIW(*(torch.as_tensor(np.asarray(p, np.float64), dtype=states.dtype,
                                        device=states.device) for p in model.baseline_prior))
    acc = list(prior)
    for k in range(K):
        traj = states[:, k]
        phi = model.baseline_basis_fn(traj[:-1].T, inputs[:-1].T)
        y = traj[1:].T
        for i, s in enumerate((phi @ y.T, phi @ phi.T, y @ y.T, float(y.shape[1]))):
            acc[i] = acc[i] + s / K
    return mniw.posterior_mean(mniw.MNIW(*acc))


def run(args: argparse.Namespace, hook: Callable | None = None) -> dict:
    """The experiment; returns the ``.mat`` dictionary it wrote.
    ``hook(event, **info)``, if given, runs after each part: ``"model"``
    (the model and the data, built on the host), ``"online"``,
    ``"reference"``, ``"gibbs-sweep"`` (``k``), ``"gibbs"``,
    ``"pgas-sweep"`` (``k``), ``"pgas"``, ``"validation"``."""
    hook = hook or (lambda event, **info: None)
    device = resolve_device("cpu" if args.cpu else "cuda")
    n_chains = max(1, args.chains)
    # before anything is made on the device: torchrun's NCCL group binds the card
    shard_mesh, chain_mesh = common.gibbs_meshes(args, n_chains, device)
    dtype = torch.float64 if args.f64 else torch.float32
    cfg = emps.EMPSConfig(n_particles=args.particles, n_gibbs=args.gibbs_iters)
    model = emps.make_model(cfg, data_dir=args.data_dir)
    data = model.data
    if data.synthetic:
        print("NOTE: DATA_EMPS.mat absent; using linear-model surrogate data")
    if args.max_steps:
        data = data._replace(time=data.time[:args.max_steps],
                             states=data.states[:args.max_steps],
                             observations=data.observations[:args.max_steps],
                             inputs=data.inputs[:args.max_steps])
    Y = torch.as_tensor(data.observations, dtype=dtype, device=device)
    inputs = torch.as_tensor(data.inputs, dtype=dtype, device=device)
    g = torch.Generator(device=device).manual_seed(cfg.seed)
    hook("model", model=model, data=data)

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
                                   ("friction F",), hook)

    # posterior mean over the Gibbs iterations
    prior = model.gp.prior_as(dtype, device)
    offline_mean = mniw.posterior_mean(
        mniw.MNIW(*(p + s.mean(0) for p, s in zip(prior, offline.stats[0]))))

    mdict = {
        **matio.offline_entries("offline", offline),
        "offline_Sigma_F": offline.int_vars[0],
        **matio.online_entries("online", online),
        "online_Sigma_F": online.int_vars[0],
        **matio.prior_entries(model.gp.prior),
        "time": data.time,
        "Y": data.observations[:, 0],
        "X": data.states,
    }

    if not args.skip_baseline:
        print("=== Offline Algorithm (classic PGAS baseline) ===")
        pgas = baseline_pgas(model, cfg.n_particles, args.pgas_iters, dtype, device)
        t0 = timelib.perf_counter()
        baseline = pgas(g, Y, inputs, model.x0, model.p0, data.states,
                        callback=lambda k, ref: hook("pgas-sweep", k=k))
        hook("pgas", result=baseline)
        print(f"{args.pgas_iters} PGAS sweeps: {timelib.perf_counter() - t0:.2f}s")
        pgas_mean = baseline_posterior_mean(model, baseline.states, inputs)

        val_data = emps.load_dataset(data_dir=args.data_dir, kind="pulses")
        rmse_alg2, rmse_pgas = emps.validation_rmse(model, offline_mean, pgas_mean,
                                                    data=val_data)
        hook("validation", rmse=(rmse_alg2, rmse_pgas), means=(offline_mean, pgas_mean))
        print(f"RMSE_Alg2: {rmse_alg2}")
        print(f"RMSE_PGAS: {rmse_pgas}")
        mdict.update({
            "offline_Sigma_X_PGAS": baseline.states,
            "offline_log_likelihood_PGAS": baseline.log_likelihood,
            "RMSE_Alg2": rmse_alg2,
            "RMSE_PGAS": rmse_pgas,
        })

    dq_plot = np.linspace(-0.15, 0.15, 500)
    mdict["dq_plot"] = dq_plot
    mdict["basis_plot"] = model.basis.eigen_fn_bl(torch.as_tensor(dq_plot)).T
    if common.lead_rank():
        matio.save_mat(args.out, mdict)
        print(f"saved {args.out}")
    return mdict


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
