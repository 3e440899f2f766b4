"""The port's copy of the plotting helpers (``bipk_tpu/utils/plotting.py``):
the colours and colour scale, the weighted moments and RMSEs, the
wRMSE curve, the weighted particle time series, the 1-D and 2-D
function-error panels and the shared figure formatting. The entry scripts
and the figure scripts draw with them. The reductions are numpy on the
host; matplotlib is imported inside the drawing functions only, so that
importing this module needs none (the card's machine has no
matplotlib)."""

from __future__ import annotations

import numpy as np

IMES_BLUE = np.array([0.0, 80.0, 155.0]) / 255.0
IMES_ORANGE = np.array([231.0, 123.0, 41.0]) / 255.0
IMES_GREEN = np.array([200.0, 211.0, 23.0]) / 255.0


def imes_colorscale():
    """The blue -> green -> orange colour map of the figures."""
    import matplotlib.colors

    return matplotlib.colors.LinearSegmentedColormap.from_list(
        "imes_Colorscale", [IMES_BLUE, IMES_GREEN, IMES_ORANGE], N=256
    )


def weighted_moments(samples: np.ndarray, weights: np.ndarray):
    """Weighted mean and std over the particle axis: ``samples (T, N)`` or
    ``(T, N, d)``, ``weights (T, N)`` -> each ``(T, d)``."""
    samples = np.asarray(samples)
    weights = np.asarray(weights)
    if samples.ndim == 2:
        samples = samples[..., None]
    mean = np.einsum("tn,tnd->td", weights, samples)
    var = np.einsum("tn,tnd->td", weights, (samples - mean[:, None, :]) ** 2)
    return mean, np.sqrt(np.maximum(var, 0.0))


def calc_wrmse(weights: np.ndarray, values: np.ndarray, truth: np.ndarray):
    """Weighted RMSE over a grid, per column: ``weights, values (G, K)``,
    ``truth (G,)`` -> ``(K,)``."""
    err2 = (np.asarray(values) - np.asarray(truth)[:, None]) ** 2
    w = np.asarray(weights)
    w = w / np.sum(w, axis=0, keepdims=True)
    return np.sqrt(np.einsum("gk,gk->k", w, err2))


def calc_wrmse_precision(fcn_mean, fcn_var, truth):
    """Precision-weighted RMSE over the function grid, per iteration, in
    its unbiased form: ``fcn_mean, fcn_var (iters, G)``, ``truth (G,)`` ->
    ``(iters,)``."""
    w = 1.0 / np.asarray(fcn_var)
    v1 = np.sum(w, axis=-1)
    v2 = np.sum(w * w, axis=-1)
    err2 = (np.asarray(fcn_mean) - np.asarray(truth)) ** 2
    return np.sqrt(1.0 / (v1 - v2 / v1**2) * np.sum(err2 * w, axis=-1))


def plot_wrmse_curve(
    wrmse, x=None, ax=None, xlabel="Iterations", ylabel="wRMSE",
):
    """A wRMSE curve over the iterations (or over time), from zero up."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(1, 1, layout="tight")
    wrmse = np.asarray(wrmse)
    if x is None:
        x = np.arange(1, wrmse.shape[0] + 1)
    ax.plot(x, wrmse, color=IMES_BLUE)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_ylim(0)
    return ax


def plot_data(time, samples, weights, truth=None, labels=None, ax=None):
    """Weighted mean ±3σ of particle time series ``samples (T, N)`` or
    ``(T, N, d)`` under ``weights (T, N)``, one axis per component, the
    truth dashed."""
    import matplotlib.pyplot as plt

    mean, std = weighted_moments(samples, weights)
    d = mean.shape[1]
    if ax is None:
        _, axes = plt.subplots(d, 1, squeeze=False)
        axes = axes[:, 0]
    else:
        axes = np.atleast_1d(ax)
    for i in range(d):
        axes[i].fill_between(
            time,
            mean[:, i] - 3 * std[:, i],
            mean[:, i] + 3 * std[:, i],
            color=IMES_BLUE,
            alpha=0.25,
            label="±3σ",
        )
        axes[i].plot(time, mean[:, i], color=IMES_BLUE, label="mean")
        if truth is not None:
            axes[i].plot(
                time,
                np.atleast_2d(np.asarray(truth).T).T[:, i],
                color=IMES_ORANGE,
                ls="--",
                label="truth",
            )
        if labels:
            axes[i].set_ylabel(labels[i])
    axes[-1].set_xlabel("time")
    axes[0].legend(loc="best", fontsize=8)
    return axes


def plot_fcn_error_1d(x_grid, mean, std, truth, data_x=None, ax=None, label="f(x)"):
    """A learned 1-D function: its posterior mean with a ±3σ band, the
    truth dashed, and a histogram of the data on a twin axis."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    x_grid, mean, std = (np.asarray(a) for a in (x_grid, mean, std))
    ax.fill_between(x_grid, mean - 3 * std, mean + 3 * std, color=IMES_BLUE, alpha=0.25)
    ax.plot(x_grid, mean, color=IMES_BLUE, label="posterior mean")
    if truth is not None:
        ax.plot(x_grid, truth, color=IMES_ORANGE, ls="--", label="truth")
    if data_x is not None:
        twin = ax.twinx()
        twin.hist(np.asarray(data_x).ravel(), bins=40, color=IMES_GREEN, alpha=0.3,
                  density=True)
        twin.set_yticks([])
    ax.set_ylabel(label)
    ax.legend(loc="best", fontsize=8)
    return ax


def fcn_error_grid_axes(fig=None):
    """The layout of a 2-D function-error panel: the main axis, marginal
    histogram axes on top and to the right, and a colour-bar axis."""
    import matplotlib.pyplot as plt

    if fig is None:
        fig = plt.figure()
    gs = fig.add_gridspec(
        2, 3,
        width_ratios=(5, 1, 0.2), height_ratios=(1, 5),
        left=0.12, right=0.88, bottom=0.12, top=0.95,
        wspace=0.05, hspace=0.05,
    )
    ax = fig.add_subplot(gs[1, 0])
    ax_histx = fig.add_subplot(gs[0, 0], sharex=ax)
    ax_histy = fig.add_subplot(gs[1, 1], sharey=ax)
    cax = fig.add_subplot(gs[1, 2])
    return fig, ax, ax_histx, ax_histy, cax


def plot_fcn_error_2d(
    grid_xy, mean, truth=None, std=None, data_xy=None, data_weights=None,
    ax=None, ax_histx=None, ax_histy=None, cax=None, norm="log",
    vmin=1e-4, vmax=3e3, alpha_sigma_cap=30.0,
):
    """A learned 2-D function's error panel:

    - tripcolor of ``|mean - truth|`` (or ``mean`` directly when ``truth``
      is None) on the IMES colorscale with a log norm;
    - per-triangle ALPHA from the posterior std — uncertain regions fade
      out (``alpha = 1 - std / alpha_sigma_cap``, clipped to ``[0, 1]``);
    - weighted data-density histograms on the top/right marginal axes;
    - colorbar on a dedicated axis.

    ``ax_histx``/``ax_histy``/``cax`` default to a fresh
    :func:`fcn_error_grid_axes` layout when not supplied.
    """
    import matplotlib.colors
    import matplotlib.pyplot as plt
    import matplotlib.tri as tri

    if ax is None:
        fig, ax, ax_histx, ax_histy, cax = fcn_error_grid_axes()
    else:
        fig = ax.figure
    grid_xy = np.asarray(grid_xy)
    value = np.asarray(mean)
    if truth is not None:
        value = np.abs(value - np.asarray(truth))

    x_min, x_max = np.min(grid_xy[:, 0]), np.max(grid_xy[:, 0])
    y_min, y_max = np.min(grid_xy[:, 1]), np.max(grid_xy[:, 1])
    triang = tri.Triangulation(grid_xy[:, 0], grid_xy[:, 1])

    # variance-based alpha: confident regions opaque, uncertain faded
    if std is not None:
        s = np.asarray(std)
        alpha = np.clip(1.0 - s / alpha_sigma_cap, 0.0, 1.0)
        alpha_faces = np.mean(alpha[triang.triangles], axis=1)
    else:
        alpha_faces = None

    if vmax is None:
        vmax = max(float(np.max(value)), vmin * 10.0)
    if norm == "log":
        normalizer = matplotlib.colors.LogNorm(vmin=vmin, vmax=vmax)
        value = np.maximum(value, vmin)
    else:
        normalizer = matplotlib.colors.Normalize(vmin=vmin, vmax=vmax)

    cntr = ax.tripcolor(
        triang, value, norm=normalizer, cmap=imes_colorscale(),
        alpha=alpha_faces, shading="flat", edgecolors="none",
    )
    ax.set_xlim(x_min, x_max)
    ax.set_ylim(y_min, y_max)

    if data_xy is not None:
        data_xy = np.asarray(data_xy)
        w = (
            np.asarray(data_weights).ravel()
            if data_weights is not None
            else None
        )
        if ax_histx is not None:
            ax_histx.tick_params(
                axis="x", which="both", bottom=False, top=False,
                labelbottom=False,
            )
            ax_histx.hist(
                data_xy[..., 0].ravel(),
                bins=np.linspace(x_min, x_max, 100),
                weights=w, color=IMES_BLUE,
            )
        if ax_histy is not None:
            ax_histy.tick_params(
                axis="y", which="both", left=False, right=False,
                labelleft=False,
            )
            ax_histy.hist(
                data_xy[..., 1].ravel(),
                bins=np.linspace(y_min, y_max, 100),
                weights=w, color=IMES_BLUE,
                orientation="horizontal",
            )
    if cax is not None:
        fig.colorbar(cntr, cax=cax)
    else:
        plt.colorbar(cntr, ax=ax, label="|error|")
    return ax


def apply_basic_formatting(fig, width=10.0, height=6.0, font_size=9):
    """Shared figure formatting: size in centimetres, a light grid, one
    font size for titles, labels and ticks (no LaTeX)."""
    fig.set_size_inches(width / 2.54, height / 2.54)
    for ax in fig.get_axes():
        ax.grid(True, which="both", alpha=0.3)
        for item in ([ax.title, ax.xaxis.label, ax.yaxis.label]
                     + ax.get_xticklabels() + ax.get_yticklabels()):
            item.set_fontsize(font_size)
    fig.tight_layout()
