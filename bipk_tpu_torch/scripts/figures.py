"""Result figures from the ``.mat`` files the port's experiment scripts
write, the port of ``scripts/figures.py``.

    python -m bipk_tpu_torch.scripts.figures plots/SingleMassOscillator_torch.mat --cpu
    python -m bipk_tpu_torch.scripts.figures plots/Vehicle_torch.mat --outdir plots
    python -m bipk_tpu_torch.scripts.figures plots/EMPS_torch.mat --cpu

The GP posterior of every Gibbs iteration is the prior plus the running
mean of the stored sufficient statistics; the matrix-t predictive of the
final (or of every) posterior is evaluated on the stored plot grid with
the port's MNIW ops (``mniw.factorize``, ``mniw.factor_predictive``), in
float64. The figures are the JAX script's PDFs under the same names:
``SingleMassOscillator_{fcn_error,wRMSE,fig}.pdf``,
``Vehicle_{fig,wRMSE}.pdf`` and ``EMPS_{wRMSE,fig}.pdf``. The predictive
runs on CUDA unless ``--cpu`` is given; the drawing needs matplotlib,
which the card's machine does not have, so run it where the ``.mat``
files were copied to.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from bipk_tpu_torch._device import resolve_device
from bipk_tpu_torch.ops import mniw
from bipk_tpu_torch.utils import plotting

F64 = torch.float64


def running_mean_posteriors(prior, T0, T1, T2, T3) -> mniw.MNIW:
    """The posterior after each Gibbs iteration, ``prior + cumsum(stat) /
    k`` (numpy, float64); the statistics carry the iteration axis first
    (``T0 (K, m, n)`` ... ``T3 (K,)``)."""

    def runmean(prior_i, stat):
        stat = np.asarray(stat)
        k = np.arange(1, stat.shape[0] + 1).reshape((-1,) + (1,) * (stat.ndim - 1))
        return np.asarray(prior_i) + np.cumsum(stat, axis=0) / k

    return mniw.MNIW(runmean(prior[0], T0), runmean(prior[1], T1), runmean(prior[2], T2),
                     runmean(prior[3].ravel()[0], np.ravel(T3)))


def _on(nat, device) -> mniw.MNIW:
    return mniw.MNIW(*(torch.as_tensor(np.asarray(a), dtype=F64, device=device) for a in nat))


def _predictive(nat: mniw.MNIW, phi: torch.Tensor):
    """Predictive mean and variance of the first output at the columns of
    ``phi (m, G)`` (an infinite variance where ``df <= 2``)."""
    pred = mniw.factor_predictive(mniw.factorize(nat), phi)
    df = pred.df
    var = pred.col_scale * pred.row_scale[0, 0] * torch.where(
        df > 2, df / (df - 2.0), torch.full_like(df, float("inf")))
    return pred.mean[0], var


def predictive_on_grid(nat: mniw.MNIW, basis_grid: np.ndarray, device):
    """Posterior-predictive mean and standard deviation ``(G,)`` (numpy)
    on a grid of basis vectors ``basis_grid (G, m)``."""
    phi = torch.as_tensor(np.asarray(basis_grid), dtype=F64, device=device).T
    mean, var = _predictive(_on(nat, device), phi)
    return mean.cpu().numpy(), torch.sqrt(var).cpu().numpy()


def predictive_series_on_grid(nats: mniw.MNIW, basis_grid: np.ndarray, device):
    """Posterior-predictive mean and variance ``(K, G)`` (numpy) on a grid
    for a series of posteriors, iteration axis first: the wRMSE curve's
    input."""
    phi = torch.as_tensor(np.asarray(basis_grid), dtype=F64, device=device).T
    series = _on(nats, device)
    means, variances = zip(*(_predictive(mniw.MNIW(*(leaf[k] for leaf in series)), phi)
                             for k in range(series.T3.shape[0])))
    return torch.stack(means).cpu().numpy(), torch.stack(variances).cpu().numpy()


def final_offline_posterior(data, prior_keys, stat_keys) -> mniw.MNIW:
    """The prior plus the Gibbs statistics averaged over the iterations."""
    prior = [data[k] for k in prior_keys]
    stats = [np.mean(data[k], axis=0) for k in stat_keys]
    return mniw.MNIW(prior[0] + stats[0], prior[1] + stats[1], prior[2] + stats[2],
                     np.asarray(prior[3].ravel()[0] + np.ravel(stats[3])[0]))


def mniw_keys(prefix, suffix=""):
    """The ``.mat`` keys of one MNIW: ``<prefix>_T0<suffix>`` ... ``T3``."""
    return [f"{prefix}_T{i}{suffix}" for i in range(4)]


def _series(data, prefix, suffix, device):
    nats = running_mean_posteriors(*([[data[k] for k in mniw_keys("prior", suffix)]]
                                     + [data[k] for k in mniw_keys(prefix, suffix)]))
    return predictive_series_on_grid(nats, data["basis_plot"], device)


def figure_oscillator(data, outdir, device):
    import matplotlib.pyplot as plt

    paths = []
    # the final posterior's error panel: variance-alpha tripcolor with
    # weighted data-density marginals
    post = final_offline_posterior(data, mniw_keys("prior"), mniw_keys("offline"))
    mean, std = predictive_on_grid(post, data["basis_plot"], device)
    truth = data["F_sd_true_plot"].ravel()
    fig, ax, ax_histx, ax_histy, cax = plotting.fcn_error_grid_axes()
    plotting.plot_fcn_error_2d(
        data["X_plot"], mean, truth, std=std, data_xy=data["offline_Sigma_X"],
        data_weights=data["offline_weights"], ax=ax, ax_histx=ax_histx, ax_histy=ax_histy,
        cax=cax, vmin=1e-1, norm="log")
    ax.set_xlabel("s in m")
    ax.set_ylabel("ds/dt in m/s")
    path = os.path.join(outdir, "SingleMassOscillator_fcn_error.pdf")
    plotting.apply_basic_formatting(fig, width=12, height=12)
    fig.savefig(path)
    paths.append(path)

    # wRMSE over the Gibbs iterations
    mean_it, var_it = _series(data, "offline", "", device)
    wrmse = plotting.calc_wrmse_precision(mean_it, var_it, truth)
    figr, axr = plt.subplots(1, 1, layout="tight")
    plotting.plot_wrmse_curve(wrmse, ax=axr, ylabel="wRMSE in N")
    plotting.apply_basic_formatting(figr, width=12, height=9)
    path = os.path.join(outdir, "SingleMassOscillator_wRMSE.pdf")
    figr.savefig(path)
    paths.append(path)

    # the state estimate
    fig2, ax2 = plt.subplots(1, 1, figsize=(6, 4))
    plotting.plot_data(data["time"].ravel(), data["offline_Sigma_X"][:, :, 0],
                       data["offline_weights"], truth=data["X"][:, 0], ax=np.atleast_1d(ax2))
    ax2.set_title(f"position draws (final wRMSE {wrmse[-1]:.2f} N)")
    plotting.apply_basic_formatting(fig2, width=14, height=11)
    path = os.path.join(outdir, "SingleMassOscillator_fig.pdf")
    fig2.savefig(path)
    paths.append(path)
    return paths


def figure_vehicle(data, outdir, device):
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    figr, axr = plt.subplots(1, 2, figsize=(11, 4))
    truth = data["mu_true_plot"].ravel()
    for i, (sfx, label) in enumerate((("_f", "front"), ("_r", "rear"))):
        post = final_offline_posterior(data, mniw_keys("prior", sfx), mniw_keys("offline", sfx))
        mean, std = predictive_on_grid(post, data["basis_plot"], device)
        plotting.plot_fcn_error_1d(data["alpha_plot"].ravel(), mean, std, truth,
                                   data_x=data[f"offline_Sigma_alpha{sfx}"], ax=axes[i],
                                   label=f"mu_y {label}")
        mean_it, var_it = _series(data, "offline", sfx, device)
        wrmse = plotting.calc_wrmse_precision(mean_it, var_it, truth)
        plotting.plot_wrmse_curve(wrmse, ax=axr[i], ylabel=f"wRMSE mu_y {label}")
    plotting.apply_basic_formatting(fig, width=28, height=11)
    path = os.path.join(outdir, "Vehicle_fig.pdf")
    fig.savefig(path)
    plotting.apply_basic_formatting(figr, width=28, height=11)
    path_r = os.path.join(outdir, "Vehicle_wRMSE.pdf")
    figr.savefig(path_r)
    return [path, path_r]


def figure_emps(data, outdir, device):
    import matplotlib.pyplot as plt

    post = final_offline_posterior(data, mniw_keys("prior"), mniw_keys("offline"))
    mean, std = predictive_on_grid(post, data["basis_plot"], device)
    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    dq = data["dq_plot"].ravel()
    axes[0].fill_between(dq, mean - 3 * std, mean + 3 * std, alpha=0.25,
                         color=plotting.IMES_BLUE)
    axes[0].plot(dq, mean, color=plotting.IMES_BLUE)
    axes[0].set_xlabel("dq")
    axes[0].set_ylabel("friction F(dq)")

    # EMPS has no true friction curve: the wRMSE of each iteration's
    # posterior against the final one
    mean_it, var_it = _series(data, "offline", "", device)
    drift = plotting.calc_wrmse_precision(mean_it, var_it, mean_it[-1])
    figr, axr = plt.subplots(1, 1, layout="tight")
    plotting.plot_wrmse_curve(drift, ax=axr, ylabel="wRMSE to final posterior")
    plotting.apply_basic_formatting(figr, width=12, height=9)
    path_r = os.path.join(outdir, "EMPS_wRMSE.pdf")
    figr.savefig(path_r)
    plotting.plot_data(data["time"].ravel(), data["offline_Sigma_X"][:, :, 0],
                       data["offline_weights"], truth=data["Y"].ravel(),
                       ax=np.atleast_1d(axes[1]))
    plotting.apply_basic_formatting(fig, width=28, height=11)
    path = os.path.join(outdir, "EMPS_fig.pdf")
    fig.savefig(path)
    return [path_r, path]


RENDERERS = {
    "SingleMassOscillator": figure_oscillator,
    "Vehicle": figure_vehicle,
    "EMPS": figure_emps,
}


def result_name(path: str) -> str:
    """The experiment of a result file: ``plots/Vehicle_torch.mat`` ->
    ``Vehicle``."""
    return os.path.splitext(os.path.basename(path))[0].removesuffix("_torch")


def main(argv=None) -> int:
    import matplotlib
    import scipy.io

    matplotlib.use("Agg")
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("matfile", help="plots/{SingleMassOscillator,Vehicle,EMPS}_torch.mat")
    p.add_argument("--outdir", default="plots")
    p.add_argument("--cpu", action="store_true", help="evaluate the predictive on the CPU")
    args = p.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")
    name = result_name(args.matfile)
    if name not in RENDERERS:
        raise SystemExit(f"unknown result file {name}; choices: {list(RENDERERS)}")
    os.makedirs(args.outdir, exist_ok=True)
    paths = RENDERERS[name](scipy.io.loadmat(args.matfile), args.outdir, device)
    print(f"saved {', '.join(paths)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
