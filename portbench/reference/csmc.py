"""The conditional SMC sweep with ancestor sampling (GP parameters
marginalized, lam = 1), from its definition, judged from the program's
traces.

A sweep conditions on a reference trajectory ``(r_x (T, dx), r_g per GP
(T, n))``. It is the filter of :mod:`portbench.reference.apf` at lam = 1
with the last slot pinned to the reference: at each step the pinned
slot's ancestor is drawn, with the uniform ``u_ref``, from the ancestor
weights ``lw + sum_GP [LBM(prior + S) - LBM(prior + F_t + S)] + log N(r_x'
; x_aux, Q)``, ``F_t`` the reference's statistics after the step and LBM
the MNIW log base measure; the pinned slot takes ``r_x'``, ``r_g'``. The
sweep ends in one trajectory drawn backwards from the final weights with
the uniform ``u_back``, and the next reference's summed statistics.

The reference judges the steps drawn for the check from the program's
carry before and after each (:func:`judge_step`), and the sweep from its
traces and its result (:func:`judge_sweep`): the pinned slot at every
time, the backward draw and the summed statistics.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import mniw
from portbench.reference.apf import (F64, Step, blocks, judge_filter, live, lookahead,
                                     systematic_in, worst_abs)
from portbench.reference.mniw import Arith, Prior


def future_stats(model, r_x, r_g, inputs):
    """``F_t`` for every step ``t``: per GP the summed statistics of the
    reference at times ``t + 1 .. T - 1``, as :class:`Prior` lists."""
    T = r_x.shape[0]
    out = []
    for i, gp in enumerate(model.gps):
        phi = model.phi(i, r_x.double().T, inputs.double().T)  # (T, m)
        st = mniw.suff(F64, r_g[i].double().reshape(T, -1), phi)
        tail = [torch.flip(torch.cumsum(torch.flip(leaf, [0]), 0), [0]) for leaf in st]
        out.append(tail)
    return [[Prior(*(leaf[t + 1] for leaf in tails[:3]), float(tails[3][t + 1]))
             for tails in out] for t in range(T - 1)]


def ancestor_weights(model, ar: Arith, x_aux, Ss, lw, r_x_next, future, jitter):
    """The pinned slot's ancestor log weights at one step."""
    N = lw.shape[0]
    g_diff = torch.zeros(N, dtype=ar.dtype, device=lw.device)
    for i, gp in enumerate(model.gps):
        for b in blocks(N):
            st = mniw.unpack(ar(Ss[i][:, b]), gp.m, gp.n)
            without = mniw.log_base_measure(mniw.factor(ar, st, gp.prior, 1.0, jitter))
            fut = Prior(*(ar(p) for p in future[i][:3]), future[i].T3)
            withf = mniw.log_base_measure(mniw.factor(ar, st, gp.prior, 1.0, jitter, extra=fut))
            g_diff[b] += without - withf
    L = ar(model.chol_q(x_aux))
    white = torch.linalg.solve_triangular(L, ar(r_x_next)[:, None] - x_aux, upper=False)
    dx = x_aux.shape[0]
    h = (-0.5 * (dx * math.log(2.0 * math.pi) + (white * white).sum(0))
         - torch.log(torch.diagonal(L)).sum())
    return ar(lw) + g_diff + h


def categorical_gap(w, u, idx):
    """How far (in probability) ``u`` lies outside the CDF interval of the
    index ``idx`` drawn with it from the weights ``w``."""
    cdf = torch.cumsum(w.double(), 0)
    lo = cdf[idx - 1] if idx > 0 else cdf.new_zeros(())
    u = float(u.double().reshape(()))
    return max(0.0, float(lo) - u, u - float(cdf[idx]))


def categorical(w, u):
    cdf = torch.cumsum(w.double(), 0)
    return int(torch.searchsorted(cdf, u.double().reshape(1)).clamp_(max=w.shape[0] - 1))


def judge_step(model, st: Step, lw_as, ess, r_x_next, r_g_next, future, jitter):
    """The numbers of one cSMC step (of the program, or of the control in
    its place): :func:`~portbench.reference.apf.judge_filter`'s at lam = 1
    with the last slot pinned, and

    - ``ancestor_weights``: the step's ancestor log weights ``lw_as``
      against the reference's (the log-determinants with and without the
      reference's future statistics, the transition density), in log
      units, over the particles of reference weight above 1e-6 of the
      largest;
    - ``ref_index``: the probability by which ``u_ref`` lies outside the
      CDF interval (float64) of the pinned slot's ancestor under the
      step's own ancestor weights: 0 where the categorical draw is exact;
    - ``ess``: the ESS of the new weights against the reference's,
      relative;
    - ``pinned``: the pinned slot's ``x'`` and ``g'`` against the
      reference trajectory's, exact.
    """
    numbers, lw_new = judge_filter(model, st, 1.0, jitter, pinned=True)
    lw, x, g, Ss = st.pre
    x_aux = model.transition(x.double(), st.u_prev.double(), [gi.double().T for gi in g])
    lw_as_ref = ancestor_weights(model, F64, x_aux, Ss, lw.double(), r_x_next.double(), future,
                                 jitter)
    numbers["ancestor_weights"] = worst_abs(lw_as, lw_as_ref, live(lw_as_ref))
    numbers["ref_index"] = categorical_gap(torch.softmax(lw_as, 0), st.draws.u_ref,
                                           int(st.anc[-1]))
    wn = torch.softmax(lw_new, 0)
    ess_ref = 1.0 / (wn * wn).sum()
    numbers["ess"] = abs(float(ess) - float(ess_ref)) / float(ess_ref)
    _, x_new, g_new, _ = st.post
    pin = (x_new[:, -1].double() - r_x_next.double()).abs().max()
    for gi, rg in zip(g_new, r_g_next):
        pin = torch.maximum(pin, (gi[:, -1].double() - rg.double().reshape(-1)).abs().max())
    numbers["pinned"] = float(pin)
    return numbers


def control_step(model, ar: Arith, pre, draws, y, u_prev, u_cur, r_x_next, r_g_next,
                 future, jitter):
    """The reference put in the program's place for one cSMC step, in
    ``ar``: from the carry ``pre = (lw, x, g (per GP (n, N)), S)`` the new
    carry, the ancestors (the pinned one drawn from its own ancestor
    weights), the first-stage and the ancestor log weights, and the ESS."""
    lw, x, g, Ss = pre
    N = x.shape[1]
    x_aux, _, ll_aux = lookahead(model, ar, ar(x), [ar(gi).T for gi in g], Ss, ar(u_prev),
                                 ar(u_cur), ar(y), 1.0, jitter)
    lw_aux = ar(lw) + ll_aux
    anc = systematic_in(ar, torch.softmax(lw_aux, 0), draws.u_res)
    lw_as = ancestor_weights(model, ar, x_aux, Ss, lw, r_x_next, future, jitter)
    sorted_anc = anc.clone()
    w_as = torch.softmax(lw_as, 0)
    anc[-1] = categorical(mniw.round_tf32(w_as.float()) if ar.tf32 else w_as, draws.u_ref)
    x_new = x_aux[:, anc] + ar.mm(ar(model.chol_q(x_aux)), ar(draws.z))
    x_new[:, -1] = ar(r_x_next)
    g_new, S_new = [], []
    for i, gp in enumerate(model.gps):
        phi = model.phi(i, x_new, ar(u_cur))
        st = mniw.unpack(ar(Ss[i][:, sorted_anc]), gp.m, gp.n)
        yv = mniw.draw(ar, mniw.factor(ar, st, gp.prior, 1.0, jitter), phi,
                       ar(draws.uvs[i][0]).T, ar(draws.uvs[i][1]).T)
        yv[-1] = ar(r_g_next[i]).reshape(-1)
        st = mniw.unpack(ar(Ss[i][:, anc]), gp.m, gp.n)
        d = mniw.suff(ar, yv, phi)
        S_new.append(mniw.pack(mniw.Stats(*(p + q for p, q in zip(st, d)))))
        g_new.append(yv.T)
    lw_new = model.loglik(ar(y), x_new, ar(u_cur), [gv.T for gv in g_new]) - ll_aux[anc]
    w = torch.softmax(lw_new, 0)
    return (lw_new, x_new, g_new, S_new), anc, lw_aux, lw_as, 1.0 / ar.mm(w, w)


def judge_sweep(model, trace, result, stats, ref, inputs, u_back, control=None):
    """The numbers of a finished sweep from its traces ``(states (T, dx,
    N), g per GP (T, n, N), ancestors (T - 1, N), final log weights
    (N,))``, its result ``(x_traj (T, dx), g_traj per GP (T, n))``, its
    summed statistics and the reference ``(r_x, r_g)`` it was conditioned
    on: ``pinned`` (the pinned slot against the reference at every time,
    exact), ``final_index`` (the backward draw's last index against the
    final weights' CDF, as ``ref_index``), ``backward`` (the trajectory
    against the traces along the ancestors from that index, exact) and
    ``traj_stats`` (the summed statistics of the trajectory, the worst leaf
    relative to its largest entry). With ``control`` (an :class:`Arith`)
    only ``traj_stats``, of the control's sums in that format."""
    x_traj, g_traj = result
    T = x_traj.shape[0]
    if control is not None:
        sums = []
        for i in range(len(model.gps)):
            phi = model.phi(i, control(x_traj).T, control(inputs).T)
            st = mniw.suff(control, control(g_traj[i]).reshape(T, -1), phi)
            sums.append([leaf.sum(0) for leaf in st])
        return {"traj_stats": _traj_stats_gap(model, x_traj, g_traj, inputs, sums)}
    states, gs, ancs, final_lw = trace
    r_x, r_g = ref
    pinned = (states[:, :, -1].double() - r_x.double()).abs().max()
    for i in range(len(model.gps)):
        pinned = torch.maximum(pinned, (gs[i][:, :, -1].double()
                                        - r_g[i].double().reshape(T, -1)).abs().max())
    idx = _final_index(states[-1], x_traj[-1])
    return {
        "pinned": float(pinned),
        "final_index": (math.inf if idx is None else
                        categorical_gap(torch.softmax(final_lw, 0), u_back, idx)),
        "backward": _backward_gap(states, gs, ancs, x_traj, g_traj, idx),
        "traj_stats": _traj_stats_gap(model, x_traj, g_traj, inputs, stats),
    }


def _final_index(states_last, x_last):
    """The particle whose final state is the trajectory's last state."""
    hit = (states_last == x_last.to(states_last.dtype)[:, None]).all(0).nonzero()
    return int(hit[0, 0]) if hit.numel() else None


def _backward_gap(states, gs, ancs, x_traj, g_traj, idx):
    """The trajectory against the trace along the ancestors from ``idx``
    (0 where it is the trace's line, exactly)."""
    if idx is None:
        return math.inf
    T = states.shape[0]
    line = [idx]
    for t in range(T - 2, -1, -1):
        line.append(int(ancs[t, line[-1]]))
    line = torch.as_tensor(line[::-1], device=states.device)
    steps = torch.arange(T, device=states.device)
    gap = (states[steps, :, line] - x_traj.to(states.dtype)).abs().max()
    for gi, gt in zip(gs, g_traj):
        gap = torch.maximum(gap, (gi[steps, :, line] - gt.reshape(T, -1).to(gi.dtype))
                            .abs().max())
    return float(gap)


def _traj_stats_gap(model, x_traj, g_traj, inputs, stats):
    worst = 0.0
    T = x_traj.shape[0]
    for i, st in enumerate(stats):
        phi = model.phi(i, x_traj.double().T, inputs.double().T)
        ref = mniw.suff(F64, g_traj[i].double().reshape(T, -1), phi)
        for got, want in zip(st, ref):
            want = want.sum(0)
            err = (got.double().reshape(want.shape) - want).abs().max() / want.abs().max()
            worst = max(worst, float(torch.nan_to_num(err, nan=math.inf)))
    return worst
