"""Algorithm 2: the PGAS Gibbs loop with marginalized GP parameters (port
of ``bipk_tpu/algorithms/gibbs.py``).

Each Gibbs iteration runs the cSMC sweep (Algorithm 3) conditioned on the
previous draw, its interface variables and its summed statistics, and
recomputes the summed statistics of the new draw. The JAX package fuses
the iterations into one ``lax.scan`` (``fused=True``) or runs them from a
host loop with checkpoints (``fused=False``); here both are a host loop of
sweeps with the same result layout. ``n_chains=C`` runs C independent
chains from the same host loop, one sweep per chain in each iteration
(the JAX package vmaps the sampler over its chains). With
``checkpoint_path`` the host loop saves the chain state (iteration, the
generators' states, the draws so far) every ``checkpoint_every`` sweeps
and resumes from an existing file, bit for bit the uninterrupted run (the
JAX ``run_host``, ``fused=False``). ``shard_mesh=`` (and ``mesh=``) runs
each sweep as the particle-sharded cSMC on the ranks of a particle mesh
(:mod:`~bipk_tpu_torch.parallel.sharded_csmc`): every rank runs the same
host loop and draws the same references, and only rank 0 writes the
checkpoint. ``chain_mesh=`` (with ``n_chains=C``) splits the chains over
the ranks of a chain mesh (:func:`~bipk_tpu_torch.parallel.mesh.chain_mesh`):
C / W chains per rank, no collective inside a sweep, the result gathered
once at the end.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from bipk_tpu_torch.algorithms.apf import as_tensor
from bipk_tpu_torch.algorithms.csmc import build_csmc
from bipk_tpu_torch.models.ssm import GPNode, SSM
from bipk_tpu_torch.ops import mniw
from bipk_tpu_torch.parallel.mesh import (CHAIN_AXIS, ChainSharding, ParticleMesh,
                                          chain_sharding, mesh_on)
from bipk_tpu_torch.utils import checkpoint
from bipk_tpu_torch.utils.matio import map_leaves


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
    init_ref_int_vars, callback=None, checkpoint_path=None,
    checkpoint_every=50)``; ``callback(k, ref)`` runs after sweep ``k``
    with the new ``(state, int_vars, stats)``.

    With ``checkpoint_path``, after sweep ``k`` with ``k %
    checkpoint_every == 0`` (and after the callback) the file holds ``k``,
    the generator's state and every reference so far (the current one
    last); an existing file resumes the chain: the generator takes the
    saved state, so the resumed run is bit for bit the uninterrupted one.
    The refusals are the JAX ``run_host``'s (``gibbs.py:384-432``). On a
    particle mesh of W ranks only rank 0 writes the file and every rank
    reads it: the shared generator's state is all a rank needs, since the
    rank generators are drawn from it at each sweep's start."""

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

    def data(self, observations, inputs):
        """The observations ``(T, dy)`` and inputs as the sweeps take them."""
        kern = self.kern
        obs = as_tensor(observations, kern.dtype, kern.device)
        return obs.reshape(obs.shape[0], -1), as_tensor(inputs, kern.dtype, kern.device)

    def initial_ref(self, init_ref_state, init_ref_int_vars, inputs):
        """The first reference ``(state (T, dx), int_vars each (T, n_i),
        stats)`` of one chain."""
        kern = self.kern
        ref_state = as_tensor(init_ref_state, kern.dtype, kern.device)
        ref_state = ref_state.reshape(ref_state.shape[0], -1)
        ref_iv = tuple(
            as_tensor(v, kern.dtype, kern.device).reshape(ref_state.shape[0], -1)
            for v in init_ref_int_vars
        )
        return ref_state, ref_iv, self._stats(ref_state, ref_iv, inputs)

    def result(self, obs, inputs, refs) -> GibbsResult:
        """One chain's references over its iterations -> its result."""
        n_gp = self.kern.n_gp
        states_kt = torch.stack([r[0] for r in refs])
        iv_kt = tuple(torch.stack([r[1][i] for r in refs]) for i in range(n_gp))
        stats_k = tuple(
            mniw.MNIW(*(torch.stack(leaves) for leaves in zip(*(r[2][i] for r in refs))))
            for i in range(n_gp)
        )
        return self.finalize(obs, inputs, states_kt, iv_kt, stats_k)

    def __call__(
        self, generator, observations, inputs, init_state_mean,
        init_state_cov, init_ref_state, init_ref_int_vars,
        callback: Callable | None = None,
        checkpoint_path: str | None = None, checkpoint_every: int = 50,
    ) -> GibbsResult:
        obs, inputs = self.data(observations, inputs)
        mesh = self.csmc.mesh
        saver = (None if checkpoint_path is None
                 else checkpoint.PeriodicCheckpointer(checkpoint_path, checkpoint_every))
        if mesh is not None and mesh.rank != 0:
            saver = None
        restored = self.restore(checkpoint_path, obs.shape[0])
        if restored is None:
            start, refs = 1, [self.initial_ref(init_ref_state, init_ref_int_vars, inputs)]
        else:
            start, rng_state, refs = restored
            generator.set_state(rng_state)
        for k in range(start, self.n_iterations):
            refs.append(self.sweep(generator, obs, inputs, init_state_mean, init_state_cov,
                                   refs[-1]))
            if callback is not None:
                callback(k, refs[-1])
            if saver is not None:
                saver(k, generator.get_state, {"refs": refs})
        return self.result(obs, inputs, refs)

    def restore(self, path, n_steps, n_chains=None):
        """The checkpoint at ``path`` as ``(next sweep, rng state, refs on
        the device)``, or None without a path or a file. ``refs`` are the
        references per iteration, with a leading ``(C,)`` on every leaf
        for ``n_chains=C``. Raises as the JAX ``run_host`` does: a
        checkpoint at or past ``n_iterations``, trajectories of another
        shape or chain count (a non-positive period is refused by
        :class:`~bipk_tpu_torch.utils.checkpoint.PeriodicCheckpointer`)."""
        if path is None:
            return None
        restored = checkpoint.load(path)
        if restored is None:
            return None
        step, rng_state, payload = restored
        if step >= self.n_iterations:
            raise ValueError(
                f"checkpoint {path!r} is at iteration {step} but this sampler runs only "
                f"{self.n_iterations} iterations; it belongs to a different run — "
                f"delete it or point --checkpoint elsewhere"
            )
        refs = payload["refs"]
        saved0 = np.shape(refs[0][0])  # (T, dx), or (C, T, dx) with chains
        if len(saved0) < 2 or saved0[-2] != n_steps or (
            len(saved0) != (2 if n_chains is None else 3)
            or (n_chains is not None and saved0[0] != n_chains)
        ):
            raise ValueError(
                f"checkpoint {path!r} holds trajectories of shape {saved0}, which does not "
                f"match this run ({n_steps} steps"
                + (f", {n_chains} chains" if n_chains is not None else "")
                + "); it belongs to a different run"
            )
        print(f"resuming Gibbs chain from {path} at sweep {step + 1}/{self.n_iterations}",
              flush=True)
        device = self.kern.device
        return step + 1, rng_state, map_leaves(
            lambda a: torch.as_tensor(a, device=device), [refs], leaf=np.ndarray)


def chain_generators(generator: torch.Generator, n_chains: int) -> list:
    """One generator per chain, on ``generator``'s device: ``n_chains``
    seeds drawn from ``generator`` at once (the host reads them once,
    before the first sweep), each seeding its chain's own generator. The
    JAX package splits the key instead (``jax.random.split(key,
    n_chains)``)."""
    seeds = torch.randint(1 << 62, (n_chains,), generator=generator,
                          device=generator.device).tolist()
    return [torch.Generator(device=generator.device).manual_seed(s) for s in seeds]


def stack_chains(trees):
    """The chains' results (or references) stacked along a new leading
    ``(C,)`` axis, leaf by leaf."""
    return map_leaves(lambda *leaves: torch.stack(leaves), trees)


def select_chain(tree, c: int):
    """Chain ``c`` of a chain-parallel result (every leaf's row ``c``)."""
    return map_leaves(lambda leaf: leaf[c], [tree])


class ParallelGibbs:
    """``n_chains`` independent Gibbs chains of one sampler, run from one
    host loop: each iteration runs one cSMC sweep per chain, each chain on
    its own generator (:func:`chain_generators`), so chain ``c`` is the
    single-chain sampler run on chain ``c``'s generator, bit for bit. Its
    kernels launch once per chain and step. Call it as :class:`Gibbs`;
    the initial reference is shared (``init_ref_state (T, dx)``, each
    ``init_ref_int_vars`` entry ``(T, n_i)`` or ``(T,)``) or per chain (a
    leading ``(C,)`` on the state and on every entry). Every
    ``GibbsResult`` field gains a leading ``(C,)`` (the stats' leaves
    ``(C, K, ...)``), and ``callback(k, ref)`` receives the chains'
    references stacked along a leading ``C``. A checkpoint holds every
    chain's generator state and the references stacked along a leading
    ``C``: the chains' generators are seeded from the caller's once, so
    the caller's state alone could not resume them.

    With ``sharding`` (a chain mesh's :class:`~bipk_tpu_torch.parallel.
    mesh.ChainSharding`, W ranks; by default one rank on the sampler's
    device, which holds every chain) each rank runs its block of C / W chains
    in the same loop, with no collective inside a sweep. Every rank draws
    all C generators from the caller's (seeded alike on every rank) and
    keeps its block, and cuts a per-chain initial reference to it, so
    chain ``c`` is chain ``c`` on one device, bit for bit. The result is
    gathered once at the end: every rank returns all C chains.
    ``callback`` receives this rank's chains only. At each checkpoint
    every rank gathers the chains' references and generator states and
    rank 0 writes them in the one-device format; every rank reads the
    file and keeps its block, so a checkpoint resumes on any number of
    ranks."""

    def __init__(self, gibbs: Gibbs, n_chains: int, sharding: ChainSharding | None = None):
        self.gibbs = gibbs
        self.kern = gibbs.kern
        self.n_iterations = gibbs.n_iterations
        self.n_chains = n_chains
        self.sharding = sharding or chain_sharding(
            ParticleMesh(None, 0, 1, gibbs.kern.device, CHAIN_AXIS))

    def chain_refs(self, init_ref_state, init_ref_int_vars):
        """The initial reference of each chain: ``[(state, int_vars)] * C``."""
        C = self.n_chains
        if torch.as_tensor(init_ref_state).dim() != 3:  # shared: chains diverge by their draws
            return [(init_ref_state, init_ref_int_vars)] * C
        if init_ref_state.shape[0] != C:
            raise ValueError(f"per-chain init_ref_state has leading axis "
                             f"{init_ref_state.shape[0]}, expected n_chains={C}")
        return [(init_ref_state[c], tuple(v[c] for v in init_ref_int_vars)) for c in range(C)]

    def _gather(self, tree):
        """A tree of this rank's chains (leading ``(C / W,)``) -> all C."""
        return map_leaves(self.sharding.gather, [tree])

    def _rng_states(self, gens) -> list:
        """Every chain's generator state (CPU byte tensors), all C."""
        stacked = torch.stack([g.get_state() for g in gens]).to(self.sharding.mesh.device)
        return list(self.sharding.gather(stacked).cpu())

    def _history(self, refs) -> list:
        """Every iteration's references so far, each stacked along a
        leading ``(C,)`` of all C chains."""
        both = self._gather(stack_chains([stack_chains(chain) for chain in refs]))
        return [map_leaves(lambda leaf: leaf[:, k], [both]) for k in range(len(refs[0]))]

    def __call__(
        self, generator, observations, inputs, init_state_mean,
        init_state_cov, init_ref_state, init_ref_int_vars,
        callback: Callable | None = None,
        checkpoint_path: str | None = None, checkpoint_every: int = 50,
    ) -> GibbsResult:
        gibbs, C = self.gibbs, self.n_chains
        gens = chain_generators(generator, C)
        obs, inputs = gibbs.data(observations, inputs)
        keep = self.sharding.keep
        saver = (None if checkpoint_path is None else checkpoint.PeriodicCheckpointer(
            checkpoint_path, checkpoint_every, write=self.sharding.mesh.rank == 0))
        restored = gibbs.restore(checkpoint_path, obs.shape[0], C)
        if restored is None:
            start = 1
            refs = [[gibbs.initial_ref(state, ivs, inputs)] for state, ivs in
                    keep(self.chain_refs(init_ref_state, init_ref_int_vars))]
        else:  # the chains' own generators continue from their saved states
            start, rng_states, stacked = restored
            for g, rng_state in zip(gens, rng_states):
                g.set_state(rng_state)
            refs = [[select_chain(r, c) for r in stacked] for c in keep(range(C))]
        gens = keep(gens)
        for k in range(start, self.n_iterations):
            for g, chain in zip(gens, refs):
                chain.append(gibbs.sweep(g, obs, inputs, init_state_mean, init_state_cov,
                                         chain[-1]))
            if callback is not None:
                callback(k, stack_chains([chain[-1] for chain in refs]))
            if saver is not None:
                saver(k, lambda: self._rng_states(gens), lambda: {"refs": self._history(refs)})
        return self._gather(stack_chains([gibbs.result(obs, inputs, chain) for chain in refs]))


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
    device: str | torch.device | None = None,
    reuse_factor: bool = False,
    dedup_gather: bool = False,
) -> Gibbs | ParallelGibbs:
    """Build the marginalized-PGAS Gibbs sampler.

    ``n_iterations`` counts the initial reference, as in the JAX package:
    the sampler runs ``n_iterations - 1`` sweeps. ``fused`` is accepted
    for the JAX signature; both values run the same host loop. ``device``
    defaults to CUDA and raises if no card is present. ``reuse_factor``
    and ``dedup_gather`` go to the cSMC sweep (:func:`~bipk_tpu_torch.
    algorithms.csmc.build_csmc`). ``n_chains=C`` (C >= 2) runs C
    independent chains (:class:`ParallelGibbs`).

    ``shard_mesh`` (a :class:`~bipk_tpu_torch.parallel.mesh.ParticleMesh`)
    runs each sweep as the particle-sharded cSMC over its ranks, as JAX
    ``gibbs.py:128-137`` does; ``mesh`` builds the same sweep
    (``build_csmc(mesh=)``: the JAX package's GSPMD, which PyTorch does not
    have, samples the same posterior). On a mesh ``device``, if given,
    must be the mesh's, and ``reuse_factor`` and ``dedup_gather`` do not
    apply.

    ``chain_mesh`` (a :func:`~bipk_tpu_torch.parallel.mesh.chain_mesh` of
    W ranks, with ``n_chains=C``, C divisible by W) runs C / W of the
    chains on each rank (:class:`ParallelGibbs` with the mesh's
    :func:`~bipk_tpu_torch.parallel.mesh.chain_sharding`), each sweep on
    the rank's device as on one device. The combinations the JAX package
    refuses (``gibbs.py:111-126``) raise ``ValueError``.
    """
    if chain_mesh is not None and n_chains is None:
        raise ValueError("chain_mesh= requires n_chains=")
    if n_chains is not None:
        if mesh is not None or shard_mesh is not None:
            raise ValueError("n_chains composes with particle-axis sharding only via "
                             "chain_mesh=; per-chain execution stays single-device")
        if n_chains < 2:
            raise ValueError(f"n_chains must be >= 2, got {n_chains}")
        if chain_mesh is not None and n_chains % chain_mesh.size:
            raise ValueError(f"n_chains={n_chains} must be divisible by the chain mesh's "
                             f"{chain_mesh.size} devices")
    if mesh is not None and shard_mesh is not None:
        raise ValueError("pass either mesh= (GSPMD) or shard_mesh=, not both")
    del fused
    if chain_mesh is not None:
        device = mesh_on(chain_mesh, device).device
    csmc = build_csmc(ssm, gps, n_particles, dtype=dtype, device=device,
                      mesh=shard_mesh if shard_mesh is not None else mesh,
                      reuse_factor=reuse_factor, dedup_gather=dedup_gather)
    gibbs = Gibbs(csmc, n_iterations)
    if n_chains is None:
        return gibbs
    return ParallelGibbs(gibbs, n_chains,
                         None if chain_mesh is None else chain_sharding(chain_mesh))
