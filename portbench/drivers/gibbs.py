"""The ``gibbs`` driver (the ``apf`` driver's traffic keys but
``host_every``): sweeps of the marginalized Gibbs sampler of
``build_gibbs``, each ``CSMC.init`` and ``CSMC.run`` on the benchmark's
draws, ``CSMC.result`` and ``summed_reference_stats``; the first sweep
conditions on the simulated trajectory and its true GP values, each later
one on the sweep before.
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from portbench import trace as trace_mod
from portbench.reference import apf as ref_apf
from portbench.reference import csmc as ref_csmc
from portbench.reference import mniw
from portbench.workload import Segments, clone, finish_ctx, merge, step_seed, sync


def run(ctx):
    from bipk_tpu_torch.algorithms.csmc import CSMCDraws
    from bipk_tpu_torch.algorithms.gibbs import build_gibbs, summed_reference_stats

    tr, dev = ctx.traffic, ctx.device
    prog = ctx.builder.program(ctx.config, dev)
    rec = ctx.builder.record(ctx.config, ctx.seed, dev)
    N = tr["particles"]
    gibbs = build_gibbs(prog.ssm, prog.gps, N, 2, dtype=torch.float32, device=dev)
    csmc = gibbs.csmc
    obs, inputs = gibbs.data(rec.Y, rec.U)
    T = obs.shape[0]
    gen = torch.Generator(device=dev)
    dx = rec.X.shape[1]
    ns = [n for _, n in prog.gp_shapes]
    state = {"i": 0, "deadline": None}
    seg = Segments(ctx, tr["trace_from"])
    captured = {}

    def draws_for(sweep, t):
        gen.manual_seed(step_seed(ctx.seed, sweep, t))
        opts = dict(generator=gen, dtype=torch.float32, device=dev)
        u_res = torch.rand((1,), **opts)
        z = torch.randn((dx, N), **opts)
        uvs = tuple((torch.rand((n, N), **opts), torch.rand((n, N), **opts)) for n in ns)
        return CSMCDraws(u_res, torch.rand((1,), **opts), z, uvs)

    def draws_iter(sweep, steps, hooks):
        for t in range(steps):
            if t and state["deadline"] is not None and time.perf_counter() >= state["deadline"]:
                return
            d = draws_for(sweep, t)
            if hooks:
                if t:
                    seg.after(state["i"] - 1)
                seg.before(state["i"])
                state["i"] += 1
            yield d
        if hooks:
            seg.after(state["i"] - 1)

    def sweep_once(sweep, ref, steps=T, hooks=True):
        """One sweep over the first ``steps`` observations; None if the
        window closed inside it."""
        ref_state, ref_iv, ref_stats = ref
        o, u, rs, ri, rsum, rT = csmc.prepare(obs[:steps], inputs[:steps], ref_state[:steps],
                                              tuple(r[:steps] for r in ref_iv), ref_stats)
        gen.manual_seed(step_seed(ctx.seed, sweep, -1))
        carry = csmc.init(gen, u[0], prog.x0, prog.p0, rs[0], tuple(r[0] for r in ri),
                          tuple(type(st)(*(leaf[0] for leaf in st)) for st in rT), rsum)
        captured.clear()

        def step(carry, *args):
            out = csmc.step(carry, *args)
            t = len(captured_t)
            captured_t.append(None)
            if hooks and t in checked_set:
                captured[t] = (clone(carry), clone(out[0]), out[1][0].clone(), out[1][1].clone())
            return out

        captured_t = []
        trace = csmc.run(carry, o, u, rs, ri, rT, draws_iter(sweep, steps - 1, hooks), step=step)
        if trace.ancestors.shape[0] < steps - 1:
            return None
        gen.manual_seed(step_seed(ctx.seed, sweep, -2))
        u_back = torch.rand((1,), generator=gen, dtype=torch.float32, device=dev)
        res = csmc.result(trace, u_back)
        new_iv = tuple(v.reshape(v.shape[0], -1) for v in res.int_var_traj)
        stats = summed_reference_stats(csmc.kern.gps, res.state_traj, new_iv, u, torch.float32)
        return trace, res, (res.state_traj, new_iv, stats), u_back

    first = gibbs.initial_ref(rec.X, rec.G, inputs)
    checked = sorted(random.Random(ctx.seed).sample(range(1, T - 1), tr["checked_steps"]))
    checked_set = set(checked)
    # warm-up: a sweep over a few observations runs every operation of a sweep
    sweep_once(-1, first, steps=tr["warmup_steps"] + 1, hooks=False)
    if ctx.trace:
        trace_mod.warm_up(dev)
    sync(dev)
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    state["deadline"] = t0 + ctx.seconds
    ref, sweep, last = first, 0, None
    while time.perf_counter() < state["deadline"]:
        out = sweep_once(sweep, ref)
        if out is None:
            break
        trace, res, new_ref, u_back = out
        last = (sweep, ref, trace, res, new_ref, u_back, dict(captured))
        ref, sweep = new_ref, sweep + 1
        del out, trace, res
        if ctx.until_checked:
            break
    sync(dev)
    window_s = time.perf_counter() - t0
    finish_ctx(ctx, seg, state["i"], window_s, setup_s)
    ctx.gp_shapes, ctx.dx, ctx.N = prog.gp_shapes, dx, N
    ctx.algorithm = "gibbs"
    ctx.logdets = True  # the step computes the log-determinants
    ctx.sweep_steps = T - 1
    ctx.distinct = None
    if last is not None:
        ancs = last[2].ancestors
        ctx.distinct = float(np.mean([torch.unique(ancs[t]).numel()
                                      for t in range(0, ancs.shape[0], 50)]))
    ref_model, jitter = ctx.reference, ctx.config["jitter"]

    def program_step(t):
        """The judged step ``t`` of the last finished sweep: its carries, its
        ancestors and ESS, and its first-stage and ancestor log weights
        from ``CSMC.lookahead`` run again on the carry before it."""
        j, cond, trace, res, new_ref, u_back, caps = last
        pre, post, anc, ess = caps[t]
        rs = cond[0]
        lw_aux, _, lw_as, _ = csmc.lookahead(pre, obs[t + 1], inputs[t], inputs[t + 1],
                                             rs[t + 1])
        st = ref_apf.Step(pre[:4], post[:4], anc, lw_aux, draws_for(j, t), obs[t + 1],
                          inputs[t], inputs[t + 1])
        return st, lw_as, ess

    def judge():
        if last is None:
            return {"sweep_completed": float("inf")}
        j, cond, trace, res, new_ref, u_back, caps = last
        futures = ref_csmc.future_stats(ref_model, cond[0], cond[1], inputs)
        numbers = {}
        for t in checked:
            st, lw_as, ess = program_step(t)
            got = ref_csmc.judge_step(ref_model, st, lw_as, ess, cond[0][t + 1],
                                      [r[t + 1] for r in cond[1]], futures[t], jitter)
            merge(numbers, got)
        got = ref_csmc.judge_sweep(
            ref_model, (trace.states, trace.int_vars, trace.ancestors, trace.final_log_weights),
            (res.state_traj, new_ref[1]), new_ref[2], (cond[0], cond[1]), inputs, u_back)
        merge(numbers, got)
        return numbers

    ctx.judge = judge
    ctx.last, ctx.checked, ctx.draws_for, ctx.record = last, checked, draws_for, rec
    ctx.inputs, ctx.program_step = inputs, program_step


def readings(ctx, control: bool):
    """The check's numbers of the run (as ``ctx.judge`` gives them), and
    with ``control`` the control's at the same steps and sweep (no
    resampler at fault: the control's ``resample`` separates here)."""
    prog = ctx.judge()
    ctrl = {}
    if not control or ctx.last is None:
        return prog, ctrl, {}
    ref, jitter = ctx.reference, ctx.config["jitter"]
    j, cond, trace, res, new_ref, u_back, caps = ctx.last
    futures = ref_csmc.future_stats(ref, cond[0], cond[1], ctx.inputs)
    for t in ctx.checked:
        st, _, _ = ctx.program_step(t)
        r_g = [r[t + 1] for r in cond[1]]
        post, anc, lw_aux, lw_as, ess = ref_csmc.control_step(
            ref, mniw.TF32, st.pre, st.draws, st.y, st.u_prev, st.u_cur, cond[0][t + 1], r_g,
            futures[t], jitter)
        merge(ctrl, ref_csmc.judge_step(ref, st._replace(post=post, anc=anc, lw_aux=lw_aux),
                                        lw_as, ess, cond[0][t + 1], r_g, futures[t], jitter))
    merge(ctrl, ref_csmc.judge_sweep(
        ref, None, (res.state_traj, new_ref[1]), None, None, ctx.inputs, None,
        control=mniw.TF32))
    return prog, ctrl, {}
