"""Exact global systematic resampling across a particle mesh (port of
``bipk_tpu/parallel/global_resampling.py``).

The single-device scheme (a stratified grid against the global weight CDF)
on particles sharded over the ranks of a :class:`~bipk_tpu_torch.parallel.
mesh.ParticleMesh`, in contrast to the local scheme of
:mod:`bipk_tpu_torch.parallel.sharded`, which resamples each rank's slice
from its locally renormalized weights:

1. **Offspring counts in closed form.** With the globally normalized
   weights and one uniform ``u`` shared by every rank, input ``i``'s
   cumulative offspring count is ``clip(ceil(N cdf_i - u), 0, N)``; a rank
   offsets its local CDF by the all-gathered masses of the ranks before
   it (one scalar per rank), so no weight vector crosses ranks.
2. **Global ancestor indices.** Every rank adds 1 at its inputs' start
   slots in an ``(N,)`` int32 buffer; a ``psum`` makes the marker global
   and a cumulative sum turns it into the sorted global ancestors (the
   single-device closed form of :func:`bipk_tpu_torch.ops.resampling.
   systematic`). This rank keeps its slice.
3. **Payloads on a ring.** Sorted ancestors make each rank's sources one
   contiguous range of global indices, which may span ranks. The payloads
   rotate around the ring; in each round a rank takes from the block it
   holds whichever of its ancestors live there. Memory stays twice the
   local payload; the traffic is one rotation.

The JAX functions are plain XLA (no Pallas kernel), and these are plain
PyTorch. They take the step's uniform as a tensor (``StepDraws.u_res``),
not a key: for the exact scheme it must be the same on every rank.
"""

from __future__ import annotations

from typing import Sequence

import torch

from bipk_tpu_torch.parallel.mesh import ParticleMesh


def _global_cdf(w_local: torch.Tensor, mesh: ParticleMesh):
    """This rank's slice of the global CDF and the mass of the ranks
    before it, in float64, as the single-device resamplers sum theirs
    (``ops/resampling.py`` ``_cdf`` says why). In the APF a zero-weight
    ancestor's second-stage weight ``ll_new - ll_aux`` is huge and takes
    the whole population's weight."""
    w = w_local.double()
    masses = mesh.all_gather_scalar(w.sum())
    before = torch.arange(mesh.size, device=masses.device) < mesh.rank
    prefix = torch.where(before, masses, torch.zeros_like(masses)).sum()
    return prefix + torch.cumsum(w, 0), prefix


def global_systematic_slice(u: torch.Tensor, w_local: torch.Tensor,
                            mesh: ParticleMesh) -> torch.Tensor:
    """This rank's slice ``(n_loc,)`` int32 of the global sorted systematic
    ancestors, as global particle indices. ``w_local`` is this rank's slice
    of the globally normalized weights, ``u`` the uniform shared by every
    rank (a one-element tensor)."""
    n_loc = w_local.shape[0]
    n_total = n_loc * mesh.size
    u = u.reshape(())
    cdf, prefix = _global_cdf(w_local, mesh)
    counts_cum = torch.clamp(torch.ceil(n_total * cdf - u), 0, n_total).long()
    # the cumulative count just before this rank's first input, in closed
    # form from the mass prefix: the previous rank's last entry
    prev_last = torch.clamp(torch.ceil(n_total * prefix - u), 0, n_total).long()
    starts = torch.cat([prev_last.reshape(1), counts_cum[:-1]])
    # starts == n_total (inputs after the mass is exhausted) land in the
    # extra slot and are dropped, as the JAX scatter's mode="drop"
    marker = torch.zeros(n_total + 1, dtype=torch.int32, device=w_local.device)
    marker.index_add_(0, starts, torch.ones_like(starts, dtype=torch.int32))
    marker = mesh.psum(marker[:n_total])
    anc = torch.clamp(torch.cumsum(marker, 0) - 1, 0, n_total - 1)
    return anc[mesh.rank * n_loc:(mesh.rank + 1) * n_loc].to(torch.int32)


def global_categorical(u: torch.Tensor, w_local: torch.Tensor,
                       mesh: ParticleMesh) -> torch.Tensor:
    """One inverse-CDF categorical draw over globally normalized sharded
    weights: the global index (0-d int32, equal on every rank) of the first
    particle whose global CDF reaches ``u``. Each rank proposes its first
    crossing and a ``pmin`` takes the first of them. ``w_local`` and ``u``
    as in :func:`global_systematic_slice`."""
    n_loc = w_local.shape[0]
    n_total = n_loc * mesh.size
    cdf, _ = _global_cdf(w_local, mesh)
    mask = cdf >= u.reshape(())
    first = torch.argmax(mask.to(torch.int32))
    cand = torch.where(mask.any(), mesh.rank * n_loc + first,
                       torch.full_like(first, n_total))
    return torch.clamp(mesh.pmin(cand), 0, n_total - 1).to(torch.int32)


def ring_redistribute(tensors: Sequence[torch.Tensor], ancestors_global: torch.Tensor,
                      mesh: ParticleMesh) -> list:
    """Each output slot's ancestor payload, wherever the ancestor lives.

    ``tensors`` are batch-last (last axis: this rank's ``n_loc``
    particles, one dtype); ``ancestors_global (n_loc,)`` are global indices
    (any order). Every tensor is packed into one ``(K, n_loc)`` matrix, so
    that each of the ``size`` rounds makes one gather and one rotation;
    the last round's rotation, which would only send the blocks home, is
    skipped, and one rank rotates nothing. Returns the tensors' gathered
    counterparts, in order."""
    n_loc = ancestors_global.shape[0]
    rows = [t.reshape(-1, n_loc) for t in tensors]
    block = torch.cat(rows, 0) if len(rows) > 1 else rows[0]
    anc = ancestors_global.long()
    if mesh.size == 1:
        out = block.index_select(1, anc)
    else:
        out = torch.zeros_like(block)
        for r in range(mesh.size):
            src = (mesh.rank - r) % mesh.size  # the rank the held block came from
            idx = anc - src * n_loc
            here = (idx >= 0) & (idx < n_loc)
            out = torch.where(here, block.index_select(1, idx.clamp(0, n_loc - 1)), out)
            if r < mesh.size - 1:
                block = mesh.rotate(block)
    parts = torch.split(out, [r.shape[0] for r in rows], 0)
    return [p.reshape(t.shape[:-1] + (n_loc,)) for p, t in zip(parts, tensors)]
