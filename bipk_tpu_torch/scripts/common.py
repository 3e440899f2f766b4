"""What the experiment scripts share: the Gibbs flags, the reference
trajectories that seed the chains, and the offline Gibbs run with its
progress, checkpoints and chain summary."""

from __future__ import annotations

import argparse
import time as timelib
from typing import Callable, Sequence

import torch

from bipk_tpu_torch.algorithms.gibbs import select_chain
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
                   help="multi-device sharding (not ported)")


def check_gibbs_flags(args: argparse.Namespace) -> None:
    if args.mesh:
        raise NotImplementedError(
            "--mesh (multi-device) is not ported yet: ROADMAP Queue A item 2")


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
    (named ``names``) over the second half of the sweeps. Returns chain
    0's result (the chains' draws are identically distributed)."""
    n_iter, n_chains = gibbs.n_iterations, max(1, args.chains)
    t0 = timelib.perf_counter()

    def progress(k, ref):
        hook("gibbs-sweep", k=k)
        if k % 100 == 0:
            print(f"  sweep {k}/{n_iter} ({timelib.perf_counter() - t0:.1f}s)", flush=True)

    offline = gibbs(g, Y, inputs, model.x0, model.p0, ref_state, ref_iv, callback=progress,
                    checkpoint_path=args.checkpoint, checkpoint_every=args.checkpoint_every)
    hook("gibbs", result=offline)
    print(f"{n_iter} Gibbs sweeps" + (f" x {n_chains} chains" if n_chains > 1 else "")
          + f": {timelib.perf_counter() - t0:.2f}s")
    if n_chains == 1:
        return offline
    for name, d in zip(names, diagnostics.gibbs_chain_summary(offline.int_vars, n_iter // 2)):
        if d["stuck"]:
            print(f"  {name}: chains never moved — the conditional SMC is degenerate at this "
                  f"configuration; increase --particles")
        else:
            print(f"  {name}: R-hat {d['rhat']:.4f}, bulk ESS {d['ess']:.0f} of "
                  f"{d['n_draws']} draws")
    return select_chain(offline, 0)
