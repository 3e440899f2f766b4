"""One gloo rank of the port's multi-rank CPU tests.

    python tests/_mesh_worker.py CASES RANK WORLD STORE OUT LIMIT

joins a gloo group of WORLD ranks through the file store STORE, runs each
case of the pickle CASES (written by the test process) on this rank's
slice of the particles, and writes every case's results, gathered to full
width, to ``OUT.<RANK>.npz``; past LIMIT seconds it ends itself (SIGALRM),
whatever its parent does. It imports torch and the port, never JAX:
the test process holds the results against the JAX package. One torch
thread; each case's name is printed before it runs, so that a rank the
test kills at its time limit shows where it was. :func:`run_ranks` starts
the ranks from a test.
"""

import os
import pickle
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bipk_tpu_torch import convert  # noqa: E402
from bipk_tpu_torch.algorithms.csmc import CSMCDraws, _at, build_csmc  # noqa: E402
from bipk_tpu_torch.algorithms.gibbs import build_gibbs  # noqa: E402
from bipk_tpu_torch.parallel import global_resampling as gr  # noqa: E402
from bipk_tpu_torch.parallel.distributed import (global_particle_mesh,  # noqa: E402
                                                 init_distributed)
from bipk_tpu_torch.parallel.mesh import ParticleMesh  # noqa: E402
from bipk_tpu_torch.parallel.sharded import (StepDraws, build_sharded_apf,  # noqa: E402
                                             gather_final)
from bipk_tpu_torch.parallel.sharded_csmc import build_sharded_csmc  # noqa: E402

F64 = torch.float64


def result_leaves(res) -> dict:
    """A sweep's moments and (full-width) final carry as numpy, by name."""
    out = {"state_mean": res.state_mean, "ess": res.ess, "final_state": res.final_state,
           "final_log_weights": res.final_log_weights}
    out.update({f"int_var_mean{i}": v for i, v in enumerate(res.int_var_mean)})
    for field, group in (("stats_mean", res.stats_mean), ("final_stats", res.final_stats)):
        out.update({f"{field}{i}.{k}": leaf for i, st in enumerate(group)
                    for k, leaf in zip(st._fields, st)})
    return {k: np.asarray(v) for k, v in out.items()}


def model_from_case(case):
    make = {"vehicle": convert.vehicle_model_from_arrays,
            "toy": convert.toy_model_from_arrays}[case["model"]]
    return make(case["config"], case["arrays"])


def build(case, mesh, model):
    return build_sharded_apf(model.ssm, model.gps, case["n"], mesh,
                             forgetting_factor=case["lam"], dtype=F64,
                             resampling_scheme=case["scheme"], device="cpu",
                             chunk_size=case.get("chunk_size"), window=case.get("window"))


def t(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def run_inject(case, mesh):
    """The sweep with an injected full-width initial carry and draws,
    sliced to this rank's columns (the resampling uniforms: ``u_res[:,
    rank]``)."""
    model = model_from_case(case)
    apf = build(case, mesh, model)
    cols = slice(mesh.rank * apf.n_loc, (mesh.rank + 1) * apf.n_loc)
    lw, state, ivs, stats = case["carry"]
    carry = convert.packed_carry_from_arrays(
        lw[cols], state[:, cols], [iv[:, cols] for iv in ivs],
        [tuple(a[..., cols] for a in st) for st in stats], F64, "cpu")
    Y, U, d = t(case["Y"]).reshape(len(case["Y"]), -1), t(case["U"]), case["draws"]
    moments = [apf.moments(apf.softmax(carry[0]), *carry[1:])]
    for s in range(Y.shape[0] - 1):
        draws = StepDraws(
            t(d["u_res"][s, mesh.rank]).reshape(1),
            None if d["z"] is None else t(d["z"][s][:, cols]),
            tuple((t(u[s][:, cols]), t(v[s][:, cols])) for u, v in d["uvs"]))
        carry, mom = apf.step(carry, Y[s + 1], U[s], U[s + 1], draws)
        moments.append(mom)
    return result_leaves(gather_final(apf.finish(moments, carry), mesh))


def run_sweeps(case, mesh):
    """The sweep as a user calls it, once per seed in ``case["seeds"]``."""
    model = model_from_case(case)
    apf = build(case, mesh, model)
    out = {}
    for seed in case["seeds"]:
        res = apf(torch.Generator().manual_seed(seed), case["Y"], case["U"], model.x0, model.p0)
        out.update({f"{seed}/{k}": v for k, v in result_leaves(gather_final(res, mesh)).items()})
    return out


def run_resampling(case, mesh):
    """``global_systematic_slice`` and ``global_categorical`` per seed
    (weights ``w[seed]``, uniform ``u[seed]``), and ``ring_redistribute`` of
    the payloads by the ancestors, all gathered to full width."""
    out = {}
    n_loc = case["n"] // mesh.size
    cols = slice(mesh.rank * n_loc, (mesh.rank + 1) * n_loc)
    for seed, (w, u) in enumerate(zip(case["w"], case["u"])):
        w_l, u = t(w)[cols], t(u).reshape(1)
        out[f"systematic{seed}"] = mesh.all_gather_last(gr.global_systematic_slice(u, w_l, mesh))
        out[f"categorical{seed}"] = gr.global_categorical(u, w_l, mesh)
    moved = gr.ring_redistribute([t(p)[..., cols] for p in case["payloads"]],
                                 torch.as_tensor(np.array(case["ancestors"][cols])), mesh)
    out.update({f"ring{i}": mesh.all_gather_last(p) for i, p in enumerate(moved)})
    return {k: np.asarray(v) for k, v in out.items()}


def run_ranks(world: int, cases: dict, tmp_dir, timeout: float = 120.0) -> list:
    """Run ``cases`` on ``world`` gloo ranks, each a child process of this
    script with ``timeout`` seconds to finish; returns each rank's results
    (a dict of numpy arrays per rank). A rank that fails, or is still
    running at its limit, stops every rank and fails the test with what
    each rank printed."""
    tmp_dir = Path(tmp_dir)
    with open(tmp_dir / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    logs = [open(tmp_dir / f"rank{r}.log", "w+") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(tmp_dir / "cases.pkl"), str(r), str(world),
         str(tmp_dir / "store"), str(tmp_dir / "out"), str(timeout)],
        stdout=logs[r], stderr=subprocess.STDOUT, env=env) for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = any(p.poll() not in (None, 0) for p in procs)
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        printed = []
        for r, log in enumerate(logs):
            log.seek(0)
            printed.append(f"--- rank {r} (exit {procs[r].returncode}):\n{log.read()}")
            log.close()
    if any(p.returncode != 0 for p in procs):
        raise AssertionError(f"{world} ranks, limit {timeout} s:\n" + "\n".join(printed))
    return [dict(np.load(tmp_dir / f"out.{r}.npz")) for r in range(world)]


def csmc_setup(case, mesh):
    """The sweep of a cSMC case on ``mesh`` (with ``single``: ``build_csmc``
    without a mesh, on one rank): ``(sweep, pinned initial carry of this
    rank's particles, the sweep's data, the injected draws sliced to this
    rank's columns, the final uniform, gather)``, ``gather`` taking this
    rank's columns to full width."""
    model = model_from_case(case)
    if case.get("single"):
        csmc = build_csmc(model.ssm, model.gps, case["n"], dtype=F64, device="cpu")
        core, cols, gather = csmc, slice(None), lambda x: x
    else:
        csmc = build_sharded_csmc(model.ssm, model.gps, case["n"], mesh, dtype=F64,
                                  chunk_size=case.get("chunk_size"))
        core, gather = csmc.csmc, mesh.all_gather_last
        cols = slice(mesh.rank * csmc.n_loc, (mesh.rank + 1) * csmc.n_loc)
    lw, state, ivs, stats = case["particles"]
    particles = convert.packed_carry_from_arrays(
        lw[cols], state[:, cols], [iv[:, cols] for iv in ivs],
        [tuple(a[..., cols] for a in st) for st in stats], F64, "cpu")
    data = core.prepare(case["Y"], case["U"], *case["ref"])
    obs, U, ref_state, ref_ivs, ref_summed, ref_T = data
    carry = csmc.pin_initial(particles, ref_state[0], tuple(r[0] for r in ref_ivs),
                             _at(ref_T, 0), ref_summed)
    d = case["draws"]
    draws = [CSMCDraws(t(d["u_res"][s]).reshape(1), t(d["u_ref"][s]).reshape(1),
                       None if d["z"] is None else t(d["z"][s][:, cols]),
                       tuple((t(u[s][:, cols]), t(v[s][:, cols])) for u, v in d["uvs"]))
             for s in range(obs.shape[0] - 1)]
    return csmc, carry, data, draws, t(case["u_final"]).reshape(1), gather


def run_csmc(case, mesh):
    """The cSMC sweep with an injected full-width initial population and
    draws, sliced per rank: its result and traces, gathered to full
    width."""
    csmc, carry, (obs, U, ref_state, ref_ivs, _, ref_T), draws, u_final, gather = \
        csmc_setup(case, mesh)
    tr = csmc.run(carry, obs, U, ref_state, ref_ivs, ref_T, draws)
    res = csmc.result(tr, u_final)
    out = {"state_traj": res.state_traj, "ess": res.ess, "log_weights": gather(res.log_weights),
           "ancestors": gather(tr.ancestors), "states": gather(tr.states)}
    out.update({f"int_var_traj{i}": v for i, v in enumerate(res.int_var_traj)})
    out.update({f"int_vars{i}": gather(v) for i, v in enumerate(tr.int_vars)})
    return {k: np.asarray(v) for k, v in out.items()}


COLLECTIVES = ("psum", "pmax", "pmin", "all_gather_scalar", "all_gather_last", "rotate")


def run_csmc_count(case, mesh):
    """The calls of each collective of the mesh (``COLLECTIVES``) in each
    step of a cSMC case's sweep (``step/<name>``, one count per step) and
    in its result, the backward draw (``result/<name>``)."""
    counts = dict.fromkeys(COLLECTIVES, 0)
    real = {name: getattr(ParticleMesh, name) for name in COLLECTIVES}

    def counting(name):
        def call(self, *args, **kwargs):
            counts[name] += 1
            return real[name](self, *args, **kwargs)
        return call

    csmc, carry, (obs, U, ref_state, ref_ivs, _, ref_T), draws, u_final, _ = \
        csmc_setup(case, mesh)
    seen = []

    def counted(draws):  # the sweep takes one step's draws just before the step
        for d in draws:
            seen.append(dict(counts))
            yield d

    for name in COLLECTIVES:
        setattr(ParticleMesh, name, counting(name))
    try:
        tr = csmc.run(carry, obs, U, ref_state, ref_ivs, ref_T, counted(draws))
        seen.append(dict(counts))
        csmc.result(tr, u_final)
    finally:
        for name in COLLECTIVES:
            setattr(ParticleMesh, name, real[name])
    out = {f"step/{k}": np.array([b[k] - a[k] for a, b in zip(seen, seen[1:])])
           for k in COLLECTIVES}
    out.update({f"result/{k}": np.asarray(counts[k] - seen[-1][k]) for k in COLLECTIVES})
    return out


def run_csmc_gibbs(case, mesh):
    """``build_gibbs(shard_mesh=mesh)`` for ``case["iterations"]``
    iterations (``full/<leaf>``), then the same sampler stopped after
    iteration 1 with a checkpoint at ``case["checkpoint"]`` (rank 0 writes
    it) and resumed from it to the end (``resumed/<leaf>``)."""
    model = model_from_case(case)
    X, ivs, _ = case["ref"]

    def gibbs(n_iterations, **kw):
        g = build_gibbs(model.ssm, model.gps, case["n"], n_iterations, dtype=F64,
                        shard_mesh=mesh)
        res = g(torch.Generator().manual_seed(case["seed"]), case["Y"], case["U"], model.x0,
                model.p0, X, ivs, **kw)
        leaves = {"states": res.states, "outputs": res.outputs,
                  "log_likelihood": res.log_likelihood}
        leaves.update({f"int_vars{i}": v for i, v in enumerate(res.int_vars)})
        leaves.update({f"stats{i}.{k}": leaf for i, st in enumerate(res.stats)
                       for k, leaf in zip(st._fields, st)})
        return leaves

    out = {f"full/{k}": v for k, v in gibbs(case["iterations"]).items()}
    ckpt = dict(checkpoint_path=case["checkpoint"], checkpoint_every=1)
    gibbs(2, **ckpt)
    dist.barrier(mesh.group)  # rank 0's checkpoint is on disk before any rank resumes
    out.update({f"resumed/{k}": v for k, v in gibbs(case["iterations"], **ckpt).items()})
    return {k: np.asarray(v) for k, v in out.items()}


RUNNERS = {"inject": run_inject, "sweeps": run_sweeps, "resampling": run_resampling,
           "csmc": run_csmc, "csmc_count": run_csmc_count, "csmc_gibbs": run_csmc_gibbs}


def main():
    cases_path, rank, world, store, out, limit = sys.argv[1:]
    rank, world = int(rank), int(world)
    signal.alarm(int(float(limit)) + 10)  # a rank never outlives its test
    torch.set_num_threads(1)
    init_distributed(device="cpu", init_method=f"file://{store}", world_size=world, rank=rank)
    try:
        mesh = global_particle_mesh()
        with open(cases_path, "rb") as f:
            cases = pickle.load(f)
        results = {}
        for name, case in cases.items():
            print(f"rank {rank} of {world}: {name}", flush=True)
            for k, v in RUNNERS[case["kind"]](case, mesh).items():
                results[f"{name}/{k}"] = v
        np.savez(f"{out}.{rank}.npz", **results)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
