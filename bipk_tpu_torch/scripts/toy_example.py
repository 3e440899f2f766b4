"""Toy experiment on one device: 1-D blind system identification, the port
of ``scripts/toy_example.py``.

    python -m bipk_tpu_torch.scripts.toy_example                        # 200 particles, 200 sweeps
    python -m bipk_tpu_torch.scripts.toy_example --quick --cpu --no-plot
    python -m bipk_tpu_torch.scripts.toy_example --chains 4             # R-hat and bulk ESS

The online APF, the offline Gibbs sampler (Algorithm 2) seeded by an APF
reference, the classic-PGAS baseline (3x the sweeps), then the posterior
predictive of the learned function on a grid from the offline and the
online statistics, drawn to ``<out>.pdf``, and a ``.mat`` file with the
JAX script's keys at ``<out>.mat``. With ``--chains C`` the Gibbs sampler
runs C chains from the one reference; the summary of the interface
variable is printed and chain 0 goes into the files. Runs on CUDA unless
``--cpu`` is given; one ``torch.Generator`` seeded with the
configuration's seed draws every random number (the simulated data from a
CPU generator seeded by its first draw). ``--no-plot`` skips the figure:
the card's machine has no matplotlib. Without the flag and without
matplotlib the script raises before it starts; the ``.mat`` file is the
same either way.
"""

from __future__ import annotations

import argparse
import os
import sys
import time as timelib
from typing import Callable

import torch

from bipk_tpu_torch._device import resolve_device
from bipk_tpu_torch.algorithms import build_apf, build_gibbs, build_pgas
from bipk_tpu_torch.algorithms.gibbs import select_chain
from bipk_tpu_torch.models import toy
from bipk_tpu_torch.ops import mniw
from bipk_tpu_torch.ops.gaussian import mvn_logpdf_chol
from bipk_tpu_torch.scripts import common
from bipk_tpu_torch.utils import diagnostics, matio

# the keys of the .mat file that run() writes, as the JAX package's
# scripts/toy_example.py writes them (:185-198)
MAT_KEYS = frozenset({
    *(f"{p}_{k}" for p in ("offline", "online")
      for k in ("Sigma_X", "Sigma_Y", "weights", "log_likelihood", "T0", "T1", "T2", "T3",
                "Sigma_F")),
    "prior_T0", "prior_T1", "prior_T2", "prior_T3", "baseline_Sigma_X",
    "baseline_log_likelihood", "x_plot", "f_true_plot", "X", "Y",
})


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--particles", type=int, default=200)
    p.add_argument("--gibbs-iters", type=int, default=200)
    p.add_argument("--chains", type=int, default=1, metavar="C",
                   help="independent Gibbs chains (C > 1: R-hat and bulk ESS printed)")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--f64", action="store_true")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (the plain versions)")
    p.add_argument("--no-plot", action="store_true",
                   help="write no figure (for a machine without matplotlib)")
    p.add_argument("--out", default="plots/Toy_Example_torch",
                   help="path of the outputs without their .mat / .pdf suffix")
    args = p.parse_args(argv)
    if args.quick:
        args.particles, args.gibbs_iters = 50, 20
    return args


def require_matplotlib() -> None:
    try:
        import matplotlib  # noqa: F401
    except ImportError as err:
        raise ImportError(
            "the toy script draws its figure with matplotlib, which is not installed; "
            "pass --no-plot to write the .mat file alone"
        ) from err


def predictive_curve(model: toy.ToyModel, stats: mniw.MNIW, phi: torch.Tensor):
    """Posterior-predictive mean and standard deviation of the learned
    function at the columns of ``phi (m, G)``, from the prior plus
    ``stats``, in ``phi``'s dtype and on its device."""
    prior = model.gp.prior_as(phi.dtype, phi.device)
    post = mniw.MNIW(*(p + s for p, s in zip(prior, stats)))
    pred = mniw.factor_predictive(mniw.factorize(post), phi)
    df = pred.df
    inflation = torch.where(df > 2, df / (df - 2.0), torch.full_like(df, float("inf")))
    return pred.mean[0], torch.sqrt(pred.col_scale * pred.row_scale[0, 0] * inflation)


def run(args: argparse.Namespace, hook: Callable | None = None) -> dict:
    """The experiment; returns the ``.mat`` dictionary it wrote.
    ``hook(event, **info)``, if given, runs after each part: ``"model"``,
    ``"online"``, ``"reference"``, ``"gibbs-sweep"`` (``k``), ``"gibbs"``,
    ``"pgas-sweep"`` (``k``), ``"pgas"``, ``"predictive"``."""
    hook = hook or (lambda event, **info: None)
    if not args.no_plot:
        require_matplotlib()
    device = resolve_device("cpu" if args.cpu else "cuda")
    dtype = torch.float64 if args.f64 else torch.float32
    cfg = toy.ToyConfig(n_particles=args.particles, n_gibbs=args.gibbs_iters)
    model = toy.make_model(cfg)
    g = torch.Generator(device=device).manual_seed(cfg.seed)
    X, Y = toy.simulate(common.simulation_generator(g), cfg, dtype=dtype, device=device)
    inputs = torch.zeros((cfg.n_steps, 0), dtype=dtype, device=device)
    hook("model", model=model, data=(X, Y))

    print("=== Online Algorithm ===")
    apf = build_apf(model.ssm, model.gps, cfg.n_particles, 1.0, dtype=dtype, device=device)
    t0 = timelib.perf_counter()
    online = apf(g, Y, inputs, model.x0, model.p0)
    hook("online", result=online)
    print(f"online sweep: {timelib.perf_counter() - t0:.2f}s")

    print("=== Offline Algorithm ===")
    ref_run = apf(g, Y, inputs, model.x0, model.p0)
    ref_state, ref_iv = matio.sample_reference_trajectory(
        torch.rand((1,), generator=g, dtype=dtype, device=device), ref_run)
    del ref_run
    hook("reference")
    n_chains = max(1, args.chains)
    gibbs = build_gibbs(model.ssm, model.gps, cfg.n_particles, cfg.n_gibbs, dtype=dtype,
                        device=device, n_chains=n_chains if n_chains > 1 else None)
    t0 = timelib.perf_counter()
    offline = gibbs(g, Y, inputs, model.x0, model.p0, ref_state, ref_iv,
                    callback=lambda k, ref: hook("gibbs-sweep", k=k))
    hook("gibbs", result=offline)
    print(f"{cfg.n_gibbs} Gibbs sweeps" + (f" x {n_chains} chains" if n_chains > 1 else "")
          + f": {timelib.perf_counter() - t0:.2f}s")
    if n_chains > 1:
        d = diagnostics.gibbs_chain_summary(offline.int_vars, cfg.n_gibbs // 2)[0]
        if d["stuck"]:
            print("chains never moved — the conditional SMC is degenerate at this "
                  "configuration; increase --particles")
        else:
            print(f"post-burn-in diagnostics over {n_chains} chains: R-hat {d['rhat']:.4f}, "
                  f"bulk ESS {d['ess']:.0f} of {d['n_draws']} draws")
        # the .mat file and the figure hold chain 0; the chains' draws are
        # identically distributed
        offline = select_chain(offline, 0)

    print("=== Classic PGAS baseline ===")
    r_chol = model.ssm.output_chol(dtype, device)
    pgas = build_pgas(
        basis_fn=lambda x, u: model.basis.eigen_fn_bl(x),
        likelihood_fn=lambda obs, x, u: mvn_logpdf_chol(obs, x, r_chol),
        prior=model.gp.prior, n_particles=cfg.n_particles, n_iterations=3 * cfg.n_gibbs,
        dtype=dtype, fused=False, device=device,
    )
    t0 = timelib.perf_counter()
    baseline = pgas(g, Y, inputs, model.x0, model.p0, ref_state,
                    callback=lambda k, ref: hook("pgas-sweep", k=k))
    hook("pgas", result=baseline)
    print(f"{3 * cfg.n_gibbs} PGAS sweeps: {timelib.perf_counter() - t0:.2f}s")

    # the posterior predictive on a grid: offline from the statistics
    # averaged over the second half of the sweeps, online from the last step
    x_plot = torch.linspace(-30.0, 30.0, 601, dtype=dtype, device=device)
    phi_plot = model.basis.eigen_fn_bl(x_plot)
    half = cfg.n_gibbs // 2
    mean_off, std_off = predictive_curve(
        model, mniw.MNIW(*(s[half:].mean(0) for s in offline.stats[0])), phi_plot)
    mean_on, std_on = predictive_curve(
        model, mniw.MNIW(*(s[-1] for s in online.stats_mean[0])), phi_plot)
    truth = toy.f_true(x_plot)
    hook("predictive", curves=(mean_off, std_off, mean_on, std_on), truth=truth)

    if not args.no_plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from bipk_tpu_torch.utils import plotting

        fig, axes = plt.subplots(1, 2, figsize=(10, 4))
        host = matio.to_host
        plotting.plot_fcn_error_1d(host(x_plot), host(mean_off), host(std_off), host(truth),
                                   data_x=host(X), ax=axes[0], label="offline (Alg 2)")
        plotting.plot_fcn_error_1d(host(x_plot), host(mean_on), host(std_on), host(truth),
                                   data_x=host(X), ax=axes[1], label="online (Alg 1)")
        plotting.apply_basic_formatting(fig, width=24, height=10)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        fig.savefig(args.out + ".pdf")
        plt.close(fig)
        print(f"saved {args.out}.pdf")

    mdict = {
        **matio.offline_entries("offline", offline),
        "offline_Sigma_F": offline.int_vars[0],
        **matio.online_entries("online", online),
        "online_Sigma_F": online.int_vars[0],
        **matio.prior_entries(model.gp.prior),
        "baseline_Sigma_X": baseline.states,
        "baseline_log_likelihood": baseline.log_likelihood,
        "x_plot": x_plot,
        "f_true_plot": truth,
        "X": X,
        "Y": Y,
    }
    matio.save_mat(args.out + ".mat", mdict)
    print(f"saved {args.out}.mat")
    return mdict


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
