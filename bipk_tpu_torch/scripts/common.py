"""What the experiment scripts share: the Gibbs flags, the meshes of
``--mesh``, the reference trajectories that seed the chains, and the
offline Gibbs run with its progress, checkpoints and chain summary."""

from __future__ import annotations

import argparse
import os
import time as timelib
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from bipk_tpu_torch.algorithms.gibbs import select_chain
from bipk_tpu_torch.parallel.distributed import init_distributed
from bipk_tpu_torch.parallel.mesh import chain_mesh, particle_mesh
from bipk_tpu_torch.utils import diagnostics, matio


def add_gibbs_flags(p: argparse.ArgumentParser) -> None:
    """``--chains``, ``--checkpoint``, ``--checkpoint-every`` and ``--mesh``,
    as the JAX scripts take them."""
    p.add_argument("--chains", type=int, default=1, metavar="C",
                   help="independent Gibbs chains (C > 1: R-hat and bulk ESS printed); each "
                        "chain starts from its own draw out of the APF population")
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="crash-safe Gibbs checkpoint; resumes if it exists")
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="run the Gibbs sampler on an N-device mesh, one rank per device "
                        "(launch N ranks with torchrun): with --chains C > 1 C / N chains "
                        "per rank, otherwise the particle-sharded cSMC")


def _has_process_group() -> bool:
    """A default process group is initialized, or torchrun's environment
    is set for one."""
    return dist.is_initialized() or "WORLD_SIZE" in os.environ


def check_gibbs_flags(args: argparse.Namespace) -> None:
    """Refuse a ``--mesh`` that cannot run: a negative one, or more than
    one rank without a process group to span."""
    if args.mesh < 0:
        raise ValueError(f"--mesh takes a number of ranks (0: no mesh), got {args.mesh}")
    if args.mesh > 1 and not _has_process_group():
        raise ValueError(
            f"--mesh {args.mesh} runs on {args.mesh} ranks: launch them with torchrun "
            f"--nproc-per-node={args.mesh} (gloo ranks with --cpu); without a process "
            "group only --mesh 1 runs")


def gibbs_meshes(args: argparse.Namespace, n_chains: int, device: torch.device):
    """``(shard_mesh, chain_mesh)`` for ``build_gibbs`` from ``--mesh N``,
    as the JAX scripts choose (``scripts/vehicle.py:116-131``): the chain
    mesh with chains, the particle mesh of the sharded cSMC without. The
    mesh spans the default process group, which torchrun's environment
    makes if none is initialized (:func:`~bipk_tpu_torch.parallel.
    distributed.init_distributed`, NCCL on CUDA and gloo on the CPU);
    without either, ``--mesh 1`` is a one-rank mesh without a group. N
    must be the world size."""
    if not args.mesh:
        return None, None
    if _has_process_group():
        init_distributed(device=device)
    make = chain_mesh if n_chains > 1 else particle_mesh
    mesh = make(args.mesh, device=device)
    return (None, mesh) if n_chains > 1 else (mesh, None)


def lead_rank() -> bool:
    """This process prints the summary and writes the result file: the
    only process, or rank 0 of the process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def simulation_generator(g: torch.Generator) -> torch.Generator:
    """The CPU generator that simulates a script's data, seeded by one draw
    of the script's generator ``g`` (the models simulate on the host)."""
    seed = int(torch.randint(1 << 62, (1,), generator=g, device=g.device))
    return torch.Generator().manual_seed(seed)


def reference_trajectories(g: torch.Generator, ref_run, n_chains: int):
    """The Gibbs sampler's initial reference: one trajectory drawn from the
    APF run ``ref_run`` per chain (the chains' uniforms drawn from ``g``
    at once), stacked along a leading ``(C,)`` for C > 1."""
    w = ref_run.weights
    u = torch.rand((n_chains,), generator=g, dtype=w.dtype, device=w.device)
    refs = [matio.sample_reference_trajectory(u[c:c + 1], ref_run) for c in range(n_chains)]
    if n_chains == 1:
        return refs[0]
    return (torch.stack([r[0] for r in refs]),
            tuple(torch.stack(ivs) for ivs in zip(*(r[1] for r in refs))))


def offline_gibbs(gibbs, g, Y, inputs, model, ref_state, ref_iv, args, names: Sequence[str],
                  hook: Callable):
    """Run the Gibbs sampler as the scripts do: ``hook("gibbs-sweep", k=k)``
    after each sweep, a progress line every 100, ``--checkpoint`` /
    ``--checkpoint-every``, then ``hook("gibbs", result=...)`` and, with
    chains, the split R-hat and bulk ESS of each GP's interface variable
    (named ``names``) over the second half of the sweeps; on a process
    group only rank 0 prints. Returns chain 0's result (the chains' draws
    are identically distributed)."""
    n_iter, n_chains = gibbs.n_iterations, max(1, args.chains)
    t0 = timelib.perf_counter()
    lead = lead_rank()

    def progress(k, ref):
        hook("gibbs-sweep", k=k)
        if lead and k % 100 == 0:
            print(f"  sweep {k}/{n_iter} ({timelib.perf_counter() - t0:.1f}s)", flush=True)

    offline = gibbs(g, Y, inputs, model.x0, model.p0, ref_state, ref_iv, callback=progress,
                    checkpoint_path=args.checkpoint, checkpoint_every=args.checkpoint_every)
    hook("gibbs", result=offline)
    if lead:
        print(f"{n_iter} Gibbs sweeps" + (f" x {n_chains} chains" if n_chains > 1 else "")
              + f": {timelib.perf_counter() - t0:.2f}s")
    if n_chains == 1:
        return offline
    summary = diagnostics.gibbs_chain_summary(offline.int_vars, n_iter // 2) if lead else []
    for name, d in zip(names, summary):
        if d["stuck"]:
            print(f"  {name}: chains never moved — the conditional SMC is degenerate at this "
                  f"configuration; increase --particles")
        else:
            print(f"  {name}: R-hat {d['rhat']:.4f}, bulk ESS {d['ess']:.0f} of "
                  f"{d['n_draws']} draws")
    return select_chain(offline, 0)
