"""The composite publication figures from all the port's result files, the
port of ``scripts/publication_figures.py``.

    python -m bipk_tpu_torch.scripts.publication_figures --plots-dir plots --cpu

Reads ``SingleMassOscillator_torch.mat``, ``Vehicle_torch.mat`` and
``EMPS_torch.mat`` from ``--plots-dir`` (whichever exist; run the
experiment scripts first) and writes, beside ``--out``, the trajectory
and function figures of the offline and the online results
(``results_{traj,fcn}_{offline,online}.pdf``), then the offline/online
comparison ``--out`` itself. The predictive runs on CUDA unless ``--cpu``
is given (:mod:`bipk_tpu_torch.scripts.figures`); the drawing needs
matplotlib.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from bipk_tpu_torch._device import resolve_device
from bipk_tpu_torch.ops import mniw
from bipk_tpu_torch.scripts.figures import (final_offline_posterior, mniw_keys,
                                            predictive_on_grid)
from bipk_tpu_torch.utils import plotting

RESULT_FILES = {"smo": "SingleMassOscillator_torch.mat", "veh": "Vehicle_torch.mat",
                "emps": "EMPS_torch.mat"}


def online_posterior(data, prior_keys, stat_keys, t=-1) -> mniw.MNIW:
    """The prior plus the online statistics at time step ``t``."""
    prior = [data[k] for k in prior_keys]
    stats = [data[k][t] for k in stat_keys]
    return mniw.MNIW(prior[0] + stats[0], prior[1] + stats[1], prior[2] + stats[2],
                     np.asarray(prior[3].ravel()[0] + np.ravel(stats[3])[0]))


def _posterior(mode, d, suffix=""):
    make = final_offline_posterior if mode == "offline" else online_posterior
    return make(d, mniw_keys("prior", suffix), mniw_keys(mode, suffix))


def _traj_panel(axes, time, sigma_x, sigma_iv, weights, truth_states, truth_iv, ylabels, title):
    """One example's column of the trajectory figure: the two state
    components and the interface variable as weighted mean ±3σ."""
    states = np.concatenate([np.atleast_3d(sigma_x), np.atleast_3d(sigma_iv)], axis=-1)
    truth = None
    if truth_states is not None and truth_iv is not None:
        truth = np.concatenate([np.atleast_2d(truth_states.T).T,
                                np.asarray(truth_iv).reshape(len(time), -1)], axis=-1)
    for i, ax in enumerate(axes):
        plotting.plot_data(time, states[..., i], weights,
                           truth=None if truth is None else truth[:, i], ax=np.atleast_1d(ax))
        ax.set_ylabel(ylabels[i])
        ax.set_xlim(time.min(), time.max())
        if i < len(axes) - 1:
            ax.tick_params(axis="x", bottom=False, labelbottom=False)
    axes[0].set_title(title)
    axes[-1].set_xlabel("Time in s")


def render_traj_figure(mode, datas, out_path):
    """``results_traj_<mode>.pdf``: one column per example, its rows the
    two states and the learned interface variable."""
    import matplotlib.pyplot as plt

    fig = plt.figure(dpi=150)
    gs = fig.add_gridspec(3, 3)
    panels = (
        ("smo", "Sigma_F", lambda d: (d["X"], d["F_sd"].ravel()),
         ["s in m", "ds/dt in m/s", "F in N"], "Nonlinear Oscillator"),
        ("veh", "Sigma_mu_f", lambda d: (d["X"], d["mu_f"].ravel() if "mu_f" in d else None),
         ["dpsi in rad/s", "v_y in m/s", "mu_f"], "Vehicle"),
        ("emps", "Sigma_F", lambda d: (None, None),
         ["q in m", "dq in m/s", "F friction"], "Real-world Positioning System"),
    )
    cols = []
    for key, iv, truth, ylabels, title in panels:
        if key not in datas:
            continue
        d = datas[key]
        axes = [fig.add_subplot(gs[i, len(cols)]) for i in range(3)]
        _traj_panel(axes, d["time"].ravel(), d[f"{mode}_Sigma_X"], d[f"{mode}_{iv}"],
                    d[f"{mode}_weights"], *truth(d), ylabels, title)
        cols.append(key)
    fig.set_layout_engine("tight")
    plotting.apply_basic_formatting(fig, width=40, height=24)
    fig.savefig(out_path)
    return cols


def render_fcn_figure(mode, datas, out_path, device):
    """``results_fcn_<mode>.pdf``: the oscillator's 2-D error panel with
    marginal histograms and a colour bar, the vehicle's and EMPS's 1-D
    function panels with data histograms."""
    import matplotlib.gridspec
    import matplotlib.pyplot as plt

    fig = plt.figure(dpi=150)
    gs = matplotlib.gridspec.GridSpec(1, 3, figure=fig)
    if "smo" in datas:
        d = datas["smo"]
        g0 = matplotlib.gridspec.GridSpecFromSubplotSpec(
            2, 3, width_ratios=(5, 1, 0.2), height_ratios=(1, 5), hspace=0.05, wspace=0.05,
            subplot_spec=gs[0, 0])
        ax = fig.add_subplot(g0[1, 0])
        ax_hx = fig.add_subplot(g0[0, 0], sharex=ax)
        ax_hy = fig.add_subplot(g0[1, 1], sharey=ax)
        cax = fig.add_subplot(g0[1, 2])
        mean, std = predictive_on_grid(_posterior(mode, d), d["basis_plot"], device)
        plotting.plot_fcn_error_2d(
            d["X_plot"], mean, d["F_sd_true_plot"].ravel(), std=std,
            data_xy=d[f"{mode}_Sigma_X"], data_weights=d[f"{mode}_weights"],
            ax=ax, ax_histx=ax_hx, ax_histy=ax_hy, cax=cax, vmin=1e-1)
        ax_hx.set_title("Nonlinear Oscillator")
        ax.set_xlabel("s in m")
        ax.set_ylabel("ds/dt in m/s")

    def fcn_1d(col, d, suffix, x_key, truth, hist_x, title, xlabel):
        g = matplotlib.gridspec.GridSpecFromSubplotSpec(
            2, 1, height_ratios=(1, 5), hspace=0.05, wspace=0.05, subplot_spec=gs[0, col])
        ax = fig.add_subplot(g[1, 0])
        ax_hx = fig.add_subplot(g[0, 0], sharex=ax)
        mean, std = predictive_on_grid(_posterior(mode, d, suffix), d["basis_plot"], device)
        plotting.plot_fcn_error_1d(d[x_key].ravel(), mean, std, truth, ax=ax, label=xlabel)
        ax_hx.hist(np.asarray(hist_x).ravel(), bins=100, color=plotting.IMES_BLUE)
        ax_hx.tick_params(axis="x", bottom=False, labelbottom=False)
        ax_hx.set_title(title)
        ax.set_xlabel(xlabel)

    if "veh" in datas:
        d = datas["veh"]
        fcn_1d(1, d, "_f", "alpha_plot", d["mu_true_plot"].ravel(), d[f"{mode}_Sigma_alpha_f"],
               "Vehicle", "alpha_f in rad")
    if "emps" in datas:
        d = datas["emps"]
        x = np.asarray(d[f"{mode}_Sigma_X"])
        fcn_1d(2, d, "", "dq_plot", None, x[..., 1] if x.ndim == 3 else x,
               "Real-world Positioning System", "dq in m/s")
    plotting.apply_basic_formatting(fig, width=40, height=14)
    fig.savefig(out_path)


def render_comparison(datas, out_path, device):
    """The offline (top) and online (bottom) function estimates of every
    example side by side; returns the examples drawn."""
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 3, figsize=(16, 8))
    panels = []
    if "smo" in datas:
        d = datas["smo"]
        truth = d["F_sd_true_plot"].ravel()
        for row, mode in enumerate(["offline", "online"]):
            mean, _ = predictive_on_grid(_posterior(mode, d), d["basis_plot"], device)
            rmse = np.sqrt(np.mean((mean - truth) ** 2))
            plotting.plot_fcn_error_2d(d["X_plot"], mean, truth, ax=axes[row, 0])
            axes[row, 0].set_title(f"SMO {mode}: F_sd error (RMSE {rmse:.2f})")
        panels.append("SMO")
    if "veh" in datas:
        d = datas["veh"]
        a = d["alpha_plot"].ravel()
        for row, mode in enumerate(["offline", "online"]):
            ax = axes[row, 1]
            for sfx, label in (("_f", "front"), ("_r", "rear")):
                mean, std = predictive_on_grid(_posterior(mode, d, sfx), d["basis_plot"], device)
                ax.plot(a, mean, label=f"{label} mean")
                ax.fill_between(a, mean - 3 * std, mean + 3 * std, alpha=0.15)
            ax.plot(a, d["mu_true_plot"].ravel(), "k--", label="truth")
            ax.set_title(f"vehicle {mode}: mu_y")
            ax.legend(fontsize=7)
        panels.append("vehicle")
    if "emps" in datas:
        d = datas["emps"]
        dq = d["dq_plot"].ravel()
        for row, mode in enumerate(["offline", "online"]):
            mean, std = predictive_on_grid(_posterior(mode, d), d["basis_plot"], device)
            ax = axes[row, 2]
            ax.plot(dq, mean)
            ax.fill_between(dq, mean - 3 * std, mean + 3 * std, alpha=0.2)
            ax.set_title(f"EMPS {mode}: friction F(dq)")
        panels.append("EMPS")
    plotting.apply_basic_formatting(fig, width=40, height=20)
    fig.savefig(out_path)
    return panels


def main(argv=None) -> int:
    import matplotlib
    import scipy.io

    matplotlib.use("Agg")
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--plots-dir", default="plots")
    p.add_argument("--out", default="plots/Publication_Figure.pdf")
    p.add_argument("--cpu", action="store_true", help="evaluate the predictive on the CPU")
    args = p.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")
    datas = {key: scipy.io.loadmat(path) for key, name in RESULT_FILES.items()
             if os.path.exists(path := os.path.join(args.plots_dir, name))}
    if not datas:
        raise SystemExit("no .mat result files found; run the experiment scripts first")
    outdir = os.path.dirname(args.out) or args.plots_dir
    os.makedirs(outdir, exist_ok=True)
    for mode in ("offline", "online"):
        render_traj_figure(mode, datas, os.path.join(outdir, f"results_traj_{mode}.pdf"))
        render_fcn_figure(mode, datas, os.path.join(outdir, f"results_fcn_{mode}.pdf"), device)
    print(f"saved results_{{traj,fcn}}_{{offline,online}}.pdf ({', '.join(datas)})")
    panels = render_comparison(datas, args.out, device)
    print(f"saved {args.out} ({', '.join(panels)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
