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
from bipk_tpu_torch.parallel import global_resampling as gr  # noqa: E402
from bipk_tpu_torch.parallel.distributed import (global_particle_mesh,  # noqa: E402
                                                 init_distributed)
from bipk_tpu_torch.parallel.sharded import (StepDraws, build_sharded_apf,  # noqa: E402
                                             gather_final)

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


RUNNERS = {"inject": run_inject, "sweeps": run_sweeps, "resampling": run_resampling}


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
