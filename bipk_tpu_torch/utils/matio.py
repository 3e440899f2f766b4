"""Result files (port of ``bipk_tpu/utils/matio.py``): the reference draw
that seeds PGAS, and the ``.mat`` writers whose keys the reference's
figure scripts read (``scipy.io.savemat`` dictionaries)."""

from __future__ import annotations

import os

import numpy as np
import torch

from bipk_tpu_torch.ops import resampling


def sample_reference_trajectory(u, apf_result):
    """One ancestral trajectory of an APF run, to seed PGAS.

    The final index is an inverse-cdf draw with the uniform ``u`` (a
    one-element tensor) from the final-time weights, as in the JAX
    package. Returns ``(state_traj (T, dx), int_var_traj)``, the latter a
    tuple of ``(T, n_i)``."""
    idx = resampling.categorical_from_weights(apf_result.weights[-1], u)
    (state_traj, iv_traj), _ = resampling.reconstruct_trajectory(
        (apf_result.states, apf_result.int_vars), apf_result.ancestors, idx
    )
    return state_traj, iv_traj


def to_host(tree):
    """Tensors of a (nested tuple, list or NamedTuple) tree -> numpy
    arrays on the host; other leaves as ``np.asarray`` gives them."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, (tuple, list)):
        out = [to_host(t) for t in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return np.asarray(tree)


def map_leaves(fn, trees, leaf=torch.Tensor):
    """``fn`` over the leaves (of type ``leaf``) at the same place in
    ``trees`` (nested lists, tuples and NamedTuples of one structure)."""
    first = trees[0]
    if isinstance(first, leaf):
        return fn(*trees)
    out = [map_leaves(fn, parts, leaf) for parts in zip(*trees)]
    return type(first)(*out) if hasattr(first, "_fields") else type(first)(out)


def save_mat(path: str, mdict: dict) -> None:
    """Write ``mdict`` (tensors or arrays) with ``scipy.io.savemat``,
    creating the directory."""
    import scipy.io

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    scipy.io.savemat(path, {k: to_host(v) for k, v in mdict.items()})


def _entries(prefix, result, stats, suffix):
    return {
        f"{prefix}_Sigma_X": result.states,
        f"{prefix}_Sigma_Y": result.outputs,
        f"{prefix}_weights": result.weights,
        f"{prefix}_log_likelihood": result.log_likelihood,
        f"{prefix}_T0{suffix}": stats.T0,
        f"{prefix}_T1{suffix}": stats.T1,
        f"{prefix}_T2{suffix}": stats.T2,
        f"{prefix}_T3{suffix}": stats.T3,
    }


def online_entries(prefix: str, apf_result, gp_index: int = 0, suffix: str = ""):
    """The online algorithm's keys (an ``APFResult``: traces and GP
    ``gp_index``'s weighted statistics); ``suffix`` names the GP where a
    model has two (``_f`` / ``_r``)."""
    return _entries(prefix, apf_result, apf_result.stats_mean[gp_index], suffix)


def offline_entries(prefix: str, gibbs_result, gp_index: int = 0, suffix: str = ""):
    """The offline algorithm's (Algorithm 2) keys, of a ``GibbsResult``."""
    return _entries(prefix, gibbs_result, gibbs_result.stats[gp_index], suffix)


def prior_entries(prior, suffix: str = ""):
    """A GP prior's natural parameters."""
    return {f"prior_T{i}{suffix}": p for i, p in enumerate(prior)}
