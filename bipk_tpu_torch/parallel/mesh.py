"""The particle and chain meshes over ``torch.distributed`` (port of
``bipk_tpu/parallel/mesh.py``).

A JAX mesh is a set of devices that one program drives through
``shard_map``; here each rank of a process group is one process that
drives one device, and :class:`ParticleMesh` carries the collectives the
JAX sharded bodies call on the particle axis:

==============================  ==========================================
JAX (``PARTICLE_AXIS``)          :class:`ParticleMesh`
==============================  ==========================================
``lax.psum``                     :meth:`~ParticleMesh.psum`: ``all_reduce(SUM)``
``lax.pmax`` / ``lax.pmin``      :meth:`~ParticleMesh.pmax` / :meth:`~ParticleMesh.pmin`
``lax.all_gather`` of a scalar   :meth:`~ParticleMesh.all_gather_scalar`
``lax.axis_index``               :attr:`~ParticleMesh.rank`
``lax.ppermute`` to ``i + 1``    :meth:`~ParticleMesh.rotate`: ``batch_isend_irecv``
==============================  ==========================================

Without a process group the mesh has one rank (JAX ``particle_mesh(1)``):
its collectives are identities and make no call into ``torch.distributed``.

The chain mesh (JAX ``chain_mesh``, axis ``CHAIN_AXIS``) is the same
object over the Gibbs-chain axis: one group of independent chains per
rank, whose sweeps make no collective. :func:`chain_sharding` is the
counterpart of its leading-axis ``NamedSharding``: it keeps a rank's block
of the chain axis and gathers the blocks back, on the mesh's collectives.
``particle_sharding`` and ``replicated`` (``NamedSharding`` objects) have no
counterpart: a rank holds its slice of the particle axis as plain tensors.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace

import torch
import torch.distributed as dist

from bipk_tpu_torch._device import resolve_device

PARTICLE_AXIS = "p"
CHAIN_AXIS = "c"


@dataclass(frozen=True)
class ParticleMesh:
    """One rank's view of a 1-D mesh over the particle axis (or, with
    ``axis=CHAIN_AXIS``, the chain axis): the process group (None for one
    rank without a group), this rank's number in it, the number of ranks,
    and the rank's device."""

    group: dist.ProcessGroup | None
    rank: int
    size: int
    device: torch.device
    axis: str = PARTICLE_AXIS

    def _all_reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        if self.group is None:
            return x
        out = x.clone()
        dist.all_reduce(out, op=op, group=self.group)
        return out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks (a new tensor)."""
        return self._all_reduce(x, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, dist.ReduceOp.MAX)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, dist.ReduceOp.MIN)

    def all_gather_scalar(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's one-element ``x`` -> ``(size,)``, in rank order."""
        x = x.reshape(1)
        if self.group is None:
            return x
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts)

    def all_gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x (..., n)`` concatenated along the last axis in
        rank order -> ``(..., size * n)``."""
        if self.group is None:
            return x
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, -1)

    def rotate(self, x: torch.Tensor) -> torch.Tensor:
        """One step around the ring: sends ``x`` to rank ``rank + 1`` and
        returns what rank ``rank - 1`` sent (``x`` itself on one rank)."""
        if self.size == 1:
            return x
        x = x.contiguous()
        out = torch.empty_like(x)
        nxt, prev = ((self.rank + d) % self.size for d in (1, -1))
        ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(self.group, nxt), self.group),
               dist.P2POp(dist.irecv, out, dist.get_global_rank(self.group, prev), self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out

    def rank_generator(self, generator: torch.Generator) -> torch.Generator:
        """This rank's generator, the counterpart of JAX's ``fold_in(key,
        shard)``: ``generator`` itself on one rank; on W ranks a new
        generator on its device, seeded by this rank's entry of W seeds
        drawn from ``generator`` (seeded alike on every rank)."""
        if self.size == 1:
            return generator
        seeds = torch.randint(1 << 62, (self.size,), generator=generator,
                              device=generator.device)
        g = torch.Generator(device=generator.device)
        return g.manual_seed(int(seeds[self.rank]))


def _local_cuda() -> torch.device:
    """``cuda:LOCAL_RANK`` (torchrun's variable), else the current card."""
    resolve_device("cuda")
    local = os.environ.get("LOCAL_RANK")
    return torch.device("cuda", int(local) if local is not None else torch.cuda.current_device())


def particle_mesh(n_devices: int | None = None, group: dist.ProcessGroup | None = None,
                  device: str | torch.device | None = None) -> ParticleMesh:
    """1-D mesh over the particle axis.

    With an initialized process group (``group``, else the default group)
    the mesh spans its ranks, one device per rank: ``cuda:LOCAL_RANK`` on
    an NCCL group, the CPU on a gloo group (which
    :func:`~bipk_tpu_torch.parallel.distributed.init_distributed` makes
    only when the caller asks for the CPU). ``device`` must agree with
    the group's backend: a CUDA mesh never runs its collectives over gloo,
    nor a CPU mesh over NCCL. ``n_devices``, if given, must be the group's
    size (a smaller mesh is a smaller group, ``dist.new_group``).

    Without a process group: a one-rank mesh on ``device`` (default
    CUDA, which raises without a card), whose collectives are identities.
    """
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        if n_devices not in (None, 1):
            raise ValueError(
                f"a mesh of {n_devices} ranks needs a process group: call "
                "init_distributed() in every rank first (torchrun, or gloo ranks on the CPU)")
        return ParticleMesh(None, 0, 1, resolve_device("cuda" if device is None else device))
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(f"n_devices={n_devices} differs from the process group's {size} "
                         "ranks; make a group of that size with dist.new_group")
    backend = dist.get_backend(group)
    if device is None:
        device = "cuda" if backend == "nccl" else "cpu"
    device = torch.device(device)
    if (device.type == "cuda") != (backend == "nccl"):
        raise ValueError(f"a mesh on {device.type} cannot run its collectives over a "
                         f"{backend} process group: NCCL for CUDA, gloo for the CPU")
    if device.type == "cuda" and device.index is None:
        device = _local_cuda()
    return ParticleMesh(group, rank, size, resolve_device(device))


def chain_mesh(n_devices: int | None = None, group: dist.ProcessGroup | None = None,
               device: str | torch.device | None = None) -> ParticleMesh:
    """1-D mesh over the Gibbs-chain axis (JAX ``chain_mesh``): one group
    of independent chains per rank, for
    ``build_gibbs(..., n_chains=C, chain_mesh=chain_mesh(W))``. The ranks,
    devices and refusals are :func:`particle_mesh`'s."""
    return replace(particle_mesh(n_devices, group, device), axis=CHAIN_AXIS)


@dataclass(frozen=True)
class ChainSharding:
    """The leading (chain) axis split over a mesh's ranks in blocks, rank
    ``r`` holding rows ``[r C / W, (r + 1) C / W)``: the counterpart of
    JAX's ``NamedSharding(mesh, P(axis))`` on a leading axis of C."""

    mesh: ParticleMesh

    def block(self, n: int) -> slice:
        """This rank's rows of a leading axis of ``n``."""
        W = self.mesh.size
        if n % W:
            raise ValueError(f"a leading axis of {n} is not divisible by the mesh's {W} ranks")
        size = n // W
        return slice(self.mesh.rank * size, (self.mesh.rank + 1) * size)

    def keep(self, x):
        """This rank's block of ``x``'s leading axis (a tensor or a list)."""
        return x[self.block(len(x))]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's block ``x (C / W, ...)`` concatenated along the
        leading axis in rank order -> ``(C, ...)``, on the mesh's
        ``all_gather_last``."""
        return self.mesh.all_gather_last(x.movedim(0, -1)).movedim(-1, 0)


def chain_sharding(mesh: ParticleMesh) -> ChainSharding:
    """Leading-axis (chain) placement on ``mesh``'s ranks."""
    return ChainSharding(mesh)


def mesh_on(mesh: ParticleMesh | None, device: str | torch.device | None) -> ParticleMesh:
    """The mesh a sharded sweep runs on: ``mesh``, or without one a
    one-rank mesh on ``device`` (default CUDA, which raises without a
    card). A ``device`` given beside a mesh must be the mesh's."""
    if mesh is None:  # one rank, whatever process group there is
        return ParticleMesh(None, 0, 1, resolve_device("cuda" if device is None else device))
    if device is not None:
        d = resolve_device(device)
        if d.type != mesh.device.type or d.index not in (None, mesh.device.index):
            raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    return mesh
