"""The yardstick itself: the plain reference agrees with the measured
package's plain path on the CPU in float64, so that what the check reads
as the program's error is the program's."""

import json
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.reference import apf as ref_apf
from portbench.reference import csmc as ref_csmc

HERE = Path(__file__).resolve().parent
TOL = 1e-9


def _setup(name, t_end):
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    cfg["t_end"] = t_end
    builder = harness.load_module(HERE / "configs" / f"{name}.py", f"cfg_{name}")
    prog = builder.program(cfg, torch.device("cpu"))
    rec = builder.record(cfg, 7, torch.device("cpu"))
    Y = rec.Y.double().reshape(rec.Y.shape[0], -1)
    return prog, Y, rec.U.double(), rec.X.double(), [g.double() for g in rec.G], \
        harness.load_module(HERE / "reference" / "models" / f"{cfg['model']}.py",
                            f"ref_{name}").build(cfg)


def _merge(into, got):
    for k, v in got.items():
        into[k] = max(into.get(k, 0.0), v)


@pytest.mark.parametrize("name", ["vehicle", "oscillator"])
def test_apf_step_f64(name):
    from bipk_tpu_torch.parallel.sharded import build_sharded_apf

    prog, Y, U, _, _, ref = _setup(name, 0.4)
    apf = build_sharded_apf(prog.ssm, prog.gps, 64, forgetting_factor=prog.lam,
                            dtype=torch.float64, device="cpu")
    gen = torch.Generator().manual_seed(3)
    carry = apf.init(gen, U[0], prog.x0, prog.p0)
    assert ref_apf.judge_init(ref, carry, U[0]) <= TOL
    worst = {}
    for t in range(Y.shape[0] - 1):
        d = apf.draws(gen)
        lw_aux = apf.kern.auxiliary_fused_packed_f(carry[3], prog.lam, carry[1], carry[2], U[t],
                                                   U[t + 1], Y[t + 1], carry[0],
                                                   emit_factor=False)[2]
        new, anc = apf.step_local(carry, Y[t + 1], U[t], U[t + 1], d)
        mom = apf.moments(apf.softmax(new[0]), *new[1:])
        st = ref_apf.Step(carry, new, anc, lw_aux, d, Y[t + 1], U[t], U[t + 1])
        _merge(worst, ref_apf.judge_step(ref, st, mom, prog.lam, 0.0))
        carry = new
    assert worst["resample"] == 0.0
    assert all(v <= TOL for v in worst.values()), worst


def test_csmc_sweep_f64():
    from bipk_tpu_torch.algorithms.csmc import build_csmc
    from bipk_tpu_torch.algorithms.gibbs import summed_reference_stats

    prog, Y, U, X, G, ref = _setup("vehicle", 0.3)
    csmc = build_csmc(prog.ssm, prog.gps, 48, dtype=torch.float64, device="cpu")
    stats = summed_reference_stats(prog.gps, X, G, U, torch.float64)
    gen = torch.Generator().manual_seed(5)
    o, u, rs, ri, rsum, rT = csmc.prepare(Y, U, X, G, stats)
    carry = csmc.init(gen, u[0], prog.x0, prog.p0, rs[0], tuple(r[0] for r in ri),
                      tuple(type(s)(*(leaf[0] for leaf in s)) for s in rT), rsum)
    futures = ref_csmc.future_stats(ref, X, G, U)
    worst, t_box = {}, [0]

    def step(c, *args):
        t = t_box[0]
        lw_aux, _, lw_as, _ = csmc.lookahead(c, Y[t + 1], U[t], U[t + 1], X[t + 1])
        new, (anc, ess) = csmc.step(c, *args)
        st = ref_apf.Step(c[:4], new[:4], anc, lw_aux, args[-1], Y[t + 1], U[t], U[t + 1])
        _merge(worst, ref_csmc.judge_step(ref, st, lw_as, ess, X[t + 1], [g[t + 1] for g in G],
                                          futures[t], 0.0))
        t_box[0] += 1
        return new, (anc, ess)

    draws = [csmc.draws(gen) for _ in range(Y.shape[0] - 1)]
    tr = csmc.run(carry, o, u, rs, ri, rT, iter(draws), step=step)
    u_back = torch.rand((1,), generator=gen, dtype=torch.float64)
    res = csmc.result(tr, u_back)
    new_iv = tuple(v.reshape(v.shape[0], -1) for v in res.int_var_traj)
    new_stats = summed_reference_stats(prog.gps, res.state_traj, new_iv, U, torch.float64)
    _merge(worst, ref_csmc.judge_sweep(
        ref, (tr.states, tr.int_vars, tr.ancestors, tr.final_log_weights),
        (res.state_traj, new_iv), new_stats, (X, G), U, u_back))
    for k in ("resample", "ref_index", "final_index", "pinned", "backward"):
        assert worst[k] == 0.0, k
    assert all(v <= TOL for v in worst.values()), worst
