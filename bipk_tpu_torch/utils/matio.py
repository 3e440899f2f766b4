"""Result-file helpers (port of ``bipk_tpu/utils/matio.py``): so far only
the reference-trajectory draw that seeds PGAS. The ``.mat`` writers come
with the entry scripts."""

from __future__ import annotations

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
