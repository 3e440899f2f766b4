"""Process-group initialization and the global particle mesh (port of
``bipk_tpu/parallel/distributed.py``).

The JAX package scales the particle axis past one host with
``jax.distributed``; here every rank is one process driving one card, and
the ranks meet in a ``torch.distributed`` process group. Typical launch,
the same program on every rank::

    torchrun --nproc-per-node=G program.py     # G cards on one machine

    from bipk_tpu_torch.parallel import distributed
    distributed.init_distributed()           # torchrun's environment
    mesh = distributed.global_particle_mesh()
    apf = build_sharded_apf(ssm, gps, n_particles, mesh, ...)

The CUDA group is NCCL and nothing else: a card whose NCCL group cannot
be made fails the call, it is never replaced by gloo or the CPU. Gloo
ranks on the CPU (``device="cpu"``) are what the tests run.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from bipk_tpu_torch._device import resolve_device
from bipk_tpu_torch.parallel.mesh import ParticleMesh, particle_mesh


def init_distributed(
    backend: str | None = None,
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    device: str | torch.device = "cuda",
    local_device_count: int | None = None,
) -> dist.ProcessGroup:
    """Join the default process group (idempotent) and return it.

    The rank and the world size come from the arguments, else from
    torchrun's ``RANK`` and ``WORLD_SIZE``; ``init_method`` defaults to
    ``env://`` (``MASTER_ADDR`` / ``MASTER_PORT``), and ``file://<path>``
    or ``tcp://host:port`` name a store directly. ``device="cuda"`` makes
    an NCCL group and binds the rank to ``cuda:LOCAL_RANK`` (raising
    without a card or without NCCL); ``device="cpu"`` makes a gloo group.
    A ``backend`` that disagrees with the device raises.

    ``local_device_count`` (JAX: virtual CPU devices in one process) has no
    counterpart and raises: on the CPU each rank is a process of its own,
    a gloo group of ``world_size`` ranks.
    """
    if local_device_count is not None:
        raise ValueError(
            "local_device_count (virtual CPU devices in one process) has no torch "
            "counterpart: start world_size processes with init_distributed(device='cpu'), "
            "gloo ranks on the CPU")
    device = resolve_device(device)
    want = "nccl" if device.type == "cuda" else "gloo"
    if backend is not None and backend != want:
        raise ValueError(f"backend {backend!r} on {device.type}: the {device.type} mesh runs "
                         f"over {want} and nothing else")
    if dist.is_initialized():
        have = dist.get_backend()
        if have != want:
            raise RuntimeError(f"the process group is {have}, not {want} for {device.type}")
        return dist.group.WORLD
    if want == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("this torch has no NCCL: a CUDA mesh cannot be made")
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    kwargs = {}
    if want == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank or 0))
        torch.cuda.set_device(local)
        # binds the communicator to the card now, so that a failed NCCL
        # init fails here and not at the first collective
        kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group(want, init_method=init_method or "env://",
                            world_size=-1 if world_size is None else world_size,
                            rank=-1 if rank is None else rank, **kwargs)
    return dist.group.WORLD


def global_particle_mesh(n_devices: int | None = None) -> ParticleMesh:
    """1-D particle mesh over every rank of the default process group (call
    :func:`init_distributed` first): one device per rank, ``cuda:LOCAL_RANK``
    on NCCL, the CPU on gloo. ``n_devices``, if given, must be the world
    size."""
    if not dist.is_initialized():
        raise RuntimeError("global_particle_mesh needs init_distributed() first")
    return particle_mesh(n_devices)
