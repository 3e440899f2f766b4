"""The ``apf`` driver (traffic keys ``particles``, ``host_every``,
``checked_steps``, ``warmup_steps``, ``trace_from``, ``trace_steps``,
``probe_steps``): the online filter of ``build_sharded_apf`` over the
configuration's record, one ``ShardedAPF.step`` per observation; at the
record's end a new filter starts from ``ShardedAPF.init``. The moments go
to the host every ``host_every`` steps. A CUDA event after every step
times the interval between step ends.
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from portbench import trace as trace_mod
from portbench.reference import apf as ref_apf
from portbench.reference import mniw
from portbench.workload import (Segments, bitwise_gap, clone, finish_ctx, flat, merge,
                                step_seed, sync)


def run(ctx):
    from bipk_tpu_torch.algorithms.apf import StepDraws
    from bipk_tpu_torch.parallel.sharded import build_sharded_apf
    from bipk_tpu_torch.utils.matio import to_host

    tr, dev = ctx.traffic, ctx.device
    prog = ctx.builder.program(ctx.config, dev)
    rec = ctx.builder.record(ctx.config, ctx.seed, dev)
    N = tr["particles"]
    T = rec.Y.shape[0]
    obs, U = rec.Y.reshape(T, -1), rec.U
    apf = build_sharded_apf(prog.ssm, prog.gps, N, forgetting_factor=prog.lam,
                            dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    dx = rec.X.shape[1]
    ns = [n for _, n in prog.gp_shapes]

    def draws_for(sweep, t):
        gen.manual_seed(step_seed(ctx.seed, sweep, t))
        opts = dict(generator=gen, dtype=torch.float32, device=dev)
        return StepDraws(torch.rand((1,), **opts), torch.randn((dx, N), **opts),
                         tuple((torch.rand((n, N), **opts), torch.rand((n, N), **opts))
                               for n in ns))

    def init_for(sweep):
        gen.manual_seed(step_seed(ctx.seed, sweep, -1))
        return apf.init(gen, U[0], prog.x0, prog.p0)

    # warm-up: every shape of the window (a start, steps, moments to the host)
    carry = init_for(-1)
    moments = []
    for t in range(tr["warmup_steps"]):
        carry, mom = apf.step(carry, obs[t + 1], U[t], U[t + 1], draws_for(-1, t))
        moments.append(mom)
    to_host(apf.stack_moments(moments))
    del carry, moments, mom
    checked = sorted(random.Random(ctx.seed).sample(range(T - 1), tr["checked_steps"]))
    if ctx.trace:
        trace_mod.warm_up(dev)
    seg = Segments(ctx, tr["trace_from"])
    seg.start = seg.clear_of(checked)
    timed = dev.type == "cuda"
    events = []
    kept = {}
    sync(dev)
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    if timed:
        start_ev = torch.cuda.Event(enable_timing=True)
        start_ev.record()
    sweep, t, i = 0, 0, 0
    carry = init_for(0)
    init_kept = clone(carry)
    new = mom = None
    moments = []
    stop_at = None
    if ctx.until_checked:
        stop_at = max(checked) + 1
        if ctx.trace:
            stop_at = max(stop_at, seg.start + seg.p + seg.k)
    while time.perf_counter() - t0 < ctx.seconds and i != stop_at:
        if t == T - 1:
            sweep, t = sweep + 1, 0
            carry = init_for(sweep)
        d = draws_for(sweep, t)
        seg.before(i)
        new, mom = apf.step(carry, obs[t + 1], U[t], U[t + 1], d)
        seg.after(i)
        if timed:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        if sweep == 0 and t in checked:
            kept[t] = (clone(carry), clone(new), clone(mom))
        moments.append(mom)
        if len(moments) == tr["host_every"]:
            to_host(apf.stack_moments(moments))
            moments = []
        carry, t, i = new, t + 1, i + 1
    sync(dev)
    window_s = time.perf_counter() - t0
    if timed:
        ms, prev = [], start_ev
        for ev in events:
            ms.append(prev.elapsed_time(ev))
            prev = ev
        ctx.step_ms = ms
    del carry, new, mom, moments, events
    finish_ctx(ctx, seg, i, window_s, setup_s)
    ctx.particle_steps = i * N
    ctx.gp_shapes, ctx.dx, ctx.N = prog.gp_shapes, dx, N
    ctx.algorithm = "apf"
    ctx.logdets = False
    ctx.distinct = None
    ref, lam, jitter = ctx.reference, prog.lam, ctx.config["jitter"]

    def program_step(t):
        """The judged step ``t``: the window's carries, and the ancestors
        and first-stage log weights of the same step run again through
        ``ShardedAPF.step_local`` and ``APFKernel.auxiliary_fused_packed_f``
        on the window's carry (``replay``: how far the step run again lies
        from the window's, exact)."""
        pre, post, mom = kept.pop(t)
        d = draws_for(0, t)
        again, anc = apf.step_local(pre, obs[t + 1], U[t], U[t + 1], d)
        lw_aux = apf.kern.auxiliary_fused_packed_f(
            pre[3], lam, pre[1], pre[2], U[t], U[t + 1], obs[t + 1], pre[0],
            emit_factor=False)[2]
        gap = max(bitwise_gap(a, b) for a, b in zip(flat(again), flat(post)))
        st = ref_apf.Step(pre, post, anc, lw_aux, d, obs[t + 1], U[t], U[t + 1])
        return st, mom, gap

    def judge():
        numbers = {"init_stats": ref_apf.judge_init(ref, init_kept, U[0]), "replay": 0.0}
        distinct = []
        for t in checked:
            if t not in kept:
                numbers["checked_step_reached"] = float("inf")
                continue
            st, mom, gap = program_step(t)
            numbers["replay"] = max(numbers["replay"], gap)
            distinct.append(int(torch.unique(st.anc).numel()))
            merge(numbers, ref_apf.judge_step(ref, st, mom, lam, jitter))
        ctx.distinct = float(np.mean(distinct)) if distinct else None
        return numbers

    ctx.judge = judge
    ctx.kept, ctx.init_kept, ctx.draws_for, ctx.record = kept, init_kept, draws_for, rec
    ctx.program_step = program_step


def readings(ctx, control: bool):
    """The check's numbers of the run (as ``ctx.judge`` gives them), and
    with ``control`` the control's at the same steps and the readings of
    ``resample`` under the resamplers at fault of
    :func:`portbench.reference.apf.resample_faults`, on the program's own
    first-stage weights."""
    ref, cfg, rec = ctx.reference, ctx.config, ctx.record
    lam, jitter = cfg["forgetting_factor"], cfg["jitter"]
    prog = {"init_stats": ref_apf.judge_init(ref, ctx.init_kept, rec.U[0]), "replay": 0.0}
    ctrl, faults = {}, {}
    for t in sorted(ctx.kept):
        st, mom, gap = ctx.program_step(t)
        prog["replay"] = max(prog["replay"], gap)
        merge(prog, ref_apf.judge_step(ref, st, mom, lam, jitter))
        if control:
            post, mom_c, anc, lw_aux = ref_apf.control_step(ref, mniw.TF32, st.pre, st.draws,
                                                            st.y, st.u_prev, st.u_cur, lam,
                                                            jitter)
            merge(ctrl, ref_apf.judge_step(ref, st._replace(post=post, anc=anc, lw_aux=lw_aux),
                                           mom_c, lam, jitter))
            got = ref_apf.resample_faults(torch.softmax(st.lw_aux, 0), st.draws.u_res, st.anc)
            merge(faults, {f"resample.{k}": v for k, v in got.items()})
    if control:
        lw, x, g, _ = ctx.init_kept
        S_c = [mniw.pack(mniw.suff(mniw.TF32, g[i].float().T, ref.phi(i, x.float(), rec.U[0])))
               for i in range(len(ref.gps))]
        ctrl["init_stats"] = ref_apf.judge_init(ref, (lw, x, g, S_c), rec.U[0])
    return prog, ctrl, faults
