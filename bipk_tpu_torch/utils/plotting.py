"""The port's copy of the plotting helpers that the toy script draws with
(``bipk_tpu/utils/plotting.py``: the colours, the weighted moments and
RMSEs, the 1-D function-error panel and the shared figure formatting).
The reductions are numpy on the host; matplotlib is imported inside the
drawing functions only, so that importing this module needs none (the
card's machine has no matplotlib)."""

from __future__ import annotations

import numpy as np

IMES_BLUE = np.array([0.0, 80.0, 155.0]) / 255.0
IMES_ORANGE = np.array([231.0, 123.0, 41.0]) / 255.0
IMES_GREEN = np.array([200.0, 211.0, 23.0]) / 255.0


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
