"""Algorithm 2: the PGAS Gibbs loop with marginalized GP parameters (port
of ``bipk_tpu/algorithms/gibbs.py``, one device and one chain).

Each Gibbs iteration runs the cSMC sweep (Algorithm 3) conditioned on the
previous draw, its interface variables and its summed statistics, and
recomputes the summed statistics of the new draw. The JAX package fuses
the iterations into one ``lax.scan`` (``fused=True``) or runs them from a
host loop with checkpoints (``fused=False``); here both are a host loop of
sweeps with the same result layout. Several chains, the sharded sweeps
and checkpointing are not ported.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from bipk_tpu_torch._device import resolve_device
from bipk_tpu_torch.algorithms.apf import as_tensor
from bipk_tpu_torch.algorithms.csmc import build_csmc
from bipk_tpu_torch.models.ssm import GPNode, SSM
from bipk_tpu_torch.ops import mniw


class GibbsResult(NamedTuple):
    """The JAX ``GibbsResult``'s fields and layouts."""

    states: torch.Tensor  # (T, K, dx), trajectory draws per iteration
    int_vars: tuple  # each (T, K, n_i)
    weights: torch.Tensor  # (T, K) uniform 1/K
    stats: tuple  # each MNIW with leading (K, ...), summed reference stats
    outputs: torch.Tensor  # (T, K, dy)
    log_likelihood: torch.Tensor  # (T, K)


def summed_reference_stats(
    gps: Sequence[GPNode], ref_state, ref_int_vars, inputs, dtype
) -> tuple:
    """The summed rank-1 statistics of a whole reference trajectory, per
    GP an MNIW ``(m, n)``, ``(m, m)``, ``(n, n)``, ``()``. ``ref_state
    (T, dx)``, ``ref_int_vars`` each ``(T, n_i)`` or ``(T,)``, ``inputs
    (T, du)``; the basis takes one input column per time point."""
    out = []
    for gp, iv in zip(gps, ref_int_vars):
        phi = gp.basis_fn_bl(ref_state.T, inputs.T)
        y = iv.to(dtype).reshape(iv.shape[0], -1).T
        out.append(mniw.MNIW(*(leaf.sum(-1) for leaf in mniw.suff_stat_bl(y, phi))))
    return tuple(out)


class Gibbs:
    """The Gibbs sampler. Call it as ``gibbs(generator, observations,
    inputs, init_state_mean, init_state_cov, init_ref_state,
    init_ref_int_vars, callback=None)``; ``callback(k, ref)`` runs after
    sweep ``k`` with the new ``(state, int_vars, stats)``."""

    def __init__(self, csmc, n_iterations: int):
        self.csmc = csmc
        self.kern = csmc.kern
        self.n_iterations = n_iterations

    def _stats(self, ref_state, ref_iv, inputs):
        return summed_reference_stats(
            self.kern.gps, ref_state, ref_iv, inputs, self.kern.dtype
        )

    def sweep(self, generator, observations, inputs, init_mean, init_cov, ref):
        """One cSMC sweep conditioned on ``ref = (state, int_vars,
        stats)``; returns the next reference."""
        res = self.csmc(generator, observations, inputs, init_mean, init_cov, *ref)
        new_iv = tuple(v.reshape(v.shape[0], -1) for v in res.int_var_traj)
        return res.state_traj, new_iv, self._stats(res.state_traj, new_iv, inputs)

    def finalize(self, observations, inputs, states_kt, iv_kt, stats_k) -> GibbsResult:
        """``(K, T, ...)`` draws -> the ``(T, K, ...)`` result with the
        model outputs and observation log densities of every draw."""
        kern = self.kern
        K, T = states_kt.shape[0], states_kt.shape[1]
        outputs, log_lik = kern.trace_outputs(
            observations, inputs, states_kt.permute(1, 2, 0),
            tuple(iv.permute(1, 2, 0) for iv in iv_kt),
        )
        return GibbsResult(
            states=states_kt.transpose(0, 1),
            int_vars=tuple(iv.transpose(0, 1) for iv in iv_kt),
            weights=torch.full((T, K), 1.0 / K, dtype=kern.dtype, device=kern.device),
            stats=stats_k,
            outputs=outputs,
            log_likelihood=log_lik,
        )

    def __call__(
        self, generator, observations, inputs, init_state_mean,
        init_state_cov, init_ref_state, init_ref_int_vars,
        callback: Callable | None = None,
    ) -> GibbsResult:
        kern = self.kern
        obs = as_tensor(observations, kern.dtype, kern.device)
        obs = obs.reshape(obs.shape[0], -1)
        inputs = as_tensor(inputs, kern.dtype, kern.device)
        ref_state = as_tensor(init_ref_state, kern.dtype, kern.device)
        ref_state = ref_state.reshape(ref_state.shape[0], -1)
        ref_iv = tuple(
            as_tensor(v, kern.dtype, kern.device).reshape(ref_state.shape[0], -1)
            for v in init_ref_int_vars
        )
        ref = (ref_state, ref_iv, self._stats(ref_state, ref_iv, inputs))
        refs = [ref]
        for k in range(1, self.n_iterations):
            ref = self.sweep(generator, obs, inputs, init_state_mean, init_state_cov, ref)
            refs.append(ref)
            if callback is not None:
                callback(k, ref)
        states_kt = torch.stack([r[0] for r in refs])
        iv_kt = tuple(torch.stack([r[1][i] for r in refs]) for i in range(kern.n_gp))
        stats_k = tuple(
            mniw.MNIW(*(torch.stack(leaves) for leaves in zip(*(r[2][i] for r in refs))))
            for i in range(kern.n_gp)
        )
        return self.finalize(obs, inputs, states_kt, iv_kt, stats_k)


def build_gibbs(
    ssm: SSM,
    gps: Sequence[GPNode],
    n_particles: int,
    n_iterations: int,
    dtype=torch.float32,
    fused: bool = True,
    mesh=None,
    shard_mesh=None,
    n_chains: int | None = None,
    chain_mesh=None,
    device: str | torch.device = "cuda",
    reuse_factor: bool = False,
    dedup_gather: bool = False,
) -> Gibbs:
    """Build the marginalized-PGAS Gibbs sampler on one device, one chain.

    ``n_iterations`` counts the initial reference, as in the JAX package:
    the sampler runs ``n_iterations - 1`` sweeps. ``fused`` is accepted
    for the JAX signature; both values run the same host loop. ``device``
    defaults to CUDA and raises if no card is present. ``reuse_factor``
    and ``dedup_gather`` go to the cSMC sweep (:func:`~bipk_tpu_torch.
    algorithms.csmc.build_csmc`). ``mesh``, ``shard_mesh``, ``n_chains``
    and ``chain_mesh`` are not ported.
    """
    if any(a is not None for a in (mesh, shard_mesh, n_chains, chain_mesh)):
        raise NotImplementedError(
            "the port's Gibbs sampler runs one chain on one device"
        )
    del fused
    device = resolve_device(device)
    csmc = build_csmc(ssm, gps, n_particles, dtype=dtype, device=device,
                      reuse_factor=reuse_factor, dedup_gather=dedup_gather)
    return Gibbs(csmc, n_iterations)
