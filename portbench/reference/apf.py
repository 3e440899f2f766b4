"""One step of the online auxiliary particle filter, from its definition,
and the numbers that judge a step of the program against it.

A step maps the carry ``(log weights lw (N,), states x (dx, N), GP values
g (per GP (n, N)), packed statistics S (per GP (rows, N)))`` and the
step's draws (the resampling offset ``u_res``, the process-noise normals
``z (dx, N)``, per GP the uniforms ``u, v (n, N)``) to the next carry:

1. look-ahead: ``x_aux = f(x, u_prev, g)``; per GP the posterior mean of
   ``prior + lam S`` at the features of ``x_aux``; the first-stage log
   weights ``lw + log p(y | x_aux, g_aux)``;
2. systematic resampling on their normalized weights: slot ``k`` takes
   the particle whose CDF interval holds ``(u_res + k) / N``;
3. propagation ``x' = x_aux[a] + chol(Q) z``; per GP the matrix-t draw
   ``g'`` from ``prior + lam S[a]`` at the features of ``x'`` and the
   statistics ``S' = lam S[a] + suff(g', phi(x'))``;
4. the log weights ``lw' = log p(y | x', g') - log p(y | x_aux[a],
   g_aux[a])`` and the weighted moments of the new carry.

The reference follows the program step by step from the program's own
carry, and judges each stage by itself: the first-stage log weights
against its own; the resampling against the CDF of the program's own
first-stage weights (the resampler's input); and, from the ancestors
the program chose, the propagation, the draw, the update and the new log
weights slot by slot, and the moments.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from portbench.reference import mniw
from portbench.reference.mniw import Arith

BLOCK = 1 << 17  # particles per block of the reference's batched algebra
F64 = Arith()


def blocks(N, size=BLOCK):
    return [slice(s, min(s + size, N)) for s in range(0, N, size)]


def lookahead(model, ar: Arith, x, g, Ss, u_prev, u_cur, y, lam, jitter):
    """``(x_aux (dx, N), g_aux per GP (N, n), ll_aux (N,))`` of states
    ``x``, GP values ``g`` (per GP ``(N, n)``) and packed ``Ss``, in
    ``ar``."""
    x_aux = model.transition(x, u_prev, g)
    N = x.shape[1]
    g_aux = [torch.empty((N, gp.n), dtype=ar.dtype, device=x.device) for gp in model.gps]
    for i, gp in enumerate(model.gps):
        for b in blocks(N):
            st = mniw.unpack(ar(Ss[i][:, b]), gp.m, gp.n)
            f = mniw.factor(ar, st, gp.prior, lam, jitter)
            g_aux[i][b] = mniw.project(ar, f, model.phi(i, x_aux[:, b], u_cur))[0]
    return x_aux, g_aux, model.loglik(y, x_aux, u_cur, g_aux)


def systematic(w, u):
    """Sorted systematic ancestors of normalized weights ``w`` (float64
    CDF): slot ``k`` takes the first particle whose CDF exceeds ``(u +
    k) / N``."""
    N = w.shape[0]
    cdf = torch.cumsum(w.double(), 0)
    grid = (u.double().reshape(()) + torch.arange(N, dtype=torch.float64, device=w.device)) / N
    return torch.searchsorted(cdf, grid, right=True).clamp_(max=N - 1)


def cdf_gap(w, u, anc, slots=None):
    """How far, in grid cells ``1 / N``, the grid point of a slot lies
    outside the CDF interval of the ancestor ``anc`` gave it, at the worst
    of ``slots`` (all by default; 0 where every ancestor holds its grid
    point). ``w`` are the reference's normalized weights."""
    N = w.shape[0]
    cdf = torch.cumsum(w.double(), 0)
    lo = torch.cat([cdf.new_zeros(1), cdf[:-1]])
    k = torch.arange(anc.shape[0], device=w.device) if slots is None else slots
    grid = (u.double().reshape(()) + k.double()) / N
    a = anc[k]
    gap = torch.maximum(lo[a] - grid, grid - cdf[a]).clamp_min(0.0)
    return float(gap.max()) * N if gap.numel() else 0.0


def resample_faults(w, u, anc):
    """:func:`cdf_gap` of two resamplers at fault on the weights ``w`` the
    ancestors ``anc`` were drawn from: ``identity`` (slot ``k`` keeps
    particle ``k``, the weights ignored) and ``shifted`` (each ancestor one
    particle on)."""
    N = w.shape[0]
    return {"identity": cdf_gap(w, u, torch.arange(N, device=w.device)),
            "shifted": cdf_gap(w, u, (anc.long() + 1).clamp_(max=N - 1))}


def advance(model, ar: Arith, x_aux, Ss, anc, z, uvs, u_cur, lam, jitter):
    """Step 3 for the slots whose ancestors are ``anc``: ``(x' (dx, K),
    g' per GP (K, n), S' per GP (rows, K))``; ``z (dx, K)``, ``uvs`` per GP
    ``(u, v)`` each ``(n, K)``."""
    x_new = x_aux[:, anc] + ar.mm(ar(model.chol_q(x_aux)), ar(z))
    g_new, S_new = [], []
    for i, gp in enumerate(model.gps):
        phi = model.phi(i, x_new, u_cur)
        st = mniw.unpack(ar(Ss[i][:, anc]), gp.m, gp.n)
        f = mniw.factor(ar, st, gp.prior, lam, jitter)
        y = mniw.draw(ar, f, phi, ar(uvs[i][0]).T, ar(uvs[i][1]).T)
        d = mniw.suff(ar, y, phi)
        S_new.append(mniw.pack(mniw.Stats(*(lam * a + b for a, b in zip(st, d)))))
        g_new.append(y)
    return x_new, g_new, S_new


class Worst:
    """The largest ``|got - want|`` and ``|want|`` per row of a leaf,
    gathered block by block; :meth:`rel` is the worst row's ratio."""

    def __init__(self):
        self.diff = self.scale = None

    def add(self, got, want):
        """``got``, ``want`` are ``(rows, K)``."""
        d = (got.double() - want.double()).abs().amax(1)
        s = want.double().abs().amax(1)
        d = torch.nan_to_num(d, nan=math.inf)
        self.diff = d if self.diff is None else torch.maximum(self.diff, d)
        self.scale = s if self.scale is None else torch.maximum(self.scale, s)

    def rel(self):
        floor = self.scale.max().clamp_min(1e-300) * 1e-12
        return float((self.diff / torch.maximum(self.scale, floor)).max())


def moments_ref(post):
    """The weighted moments of a carry in float64, each component with its
    weighted standard deviation: ``[(mean, std)]`` for the states, every
    GP's values, every GP's packed statistics, and ``(ess, 0)``."""
    lw, x, g, Ss = post
    w = torch.softmax(lw.double(), 0)
    out = []
    for leaf in (x, *g, *Ss):
        v = leaf.double()
        mean = v @ w
        std = torch.sqrt(((v - mean[:, None]) ** 2) @ w)
        out.append((mean, std))
    ess = 1.0 / (w * w).sum()
    out.append((ess.reshape(1), torch.zeros(1, dtype=torch.float64, device=w.device)))
    return out


def moments_gap(moments, post):
    """The largest ``|program - reference| / (|reference| + std)`` over
    every component of the step's moments: the states' mean, each GP's
    mean value and mean statistics, the ESS."""
    x_mean, g_means, S_means, ess = moments
    got = [x_mean, *g_means, *S_means, ess.reshape(1)]
    worst = 0.0
    for p, (r, s) in zip(got, moments_ref(post)):
        e = (p.double().reshape(-1) - r).abs() / (r.abs() + s).clamp_min(1e-300)
        worst = max(worst, float(torch.nan_to_num(e, nan=math.inf).max()))
    return worst


class Step(NamedTuple):
    """One judged step of the program (or of the control in its place):
    the carry before and after it, the ancestors it chose (the pinned one
    included in the cSMC), its first-stage log weights (the resampler's
    input), its draws, and its observation and inputs."""

    pre: tuple
    post: tuple
    anc: torch.Tensor
    lw_aux: torch.Tensor
    draws: tuple
    y: torch.Tensor
    u_prev: torch.Tensor
    u_cur: torch.Tensor


def live(lw, share=1e-6):
    """The particles whose normalized weight is at least ``share`` of the
    largest."""
    w = torch.softmax(lw, 0)
    return w >= share * w.max()


def worst_abs(got, want, mask):
    d = (got.double() - want.double()).abs()[mask]
    return float(torch.nan_to_num(d, nan=math.inf).max()) if d.numel() else 0.0


def judge_filter(model, st: Step, lam, jitter, pinned: bool = False):
    """The numbers every filter step has, from the step's carry in float64:

    - ``lookahead``: the first-stage log weights against the reference's
      (the physics, the bases, the look-ahead's factorization and
      projection, the likelihood), in log units, over the particles of
      reference weight above 1e-6 of the largest;
    - ``resample``: grid cells by which a resampled slot's grid point lies
      outside the CDF interval (float64) of its ancestor under the step's
      own first-stage weights (the resampler);
    - ``state``: ``x'`` against ``x_aux[a] + chol(Q) z`` (the propagation),
      the worst state's largest difference over its largest value;
    - ``gp_value``: ``g'`` against the reference's matrix-t draw at the
      ancestor's statistics (the gather and the draw), likewise per GP;
    - ``stats``: ``S'`` against ``lam S[a] + suff(g', phi(x'))`` (the
      rank-1 update), the worst row of the packed layout;
    - ``log_weight``: ``lw'`` against the reference's, in log units, over
      the slots of reference weight above 1e-6 of the largest.

    With ``pinned`` (the cSMC) the last slot holds the reference: it takes
    no part in ``resample``, ``state`` and ``gp_value``, and its
    statistics and log weight follow from its own ``x'``, ``g'``. Returns
    the numbers and the reference's new log weights."""
    lw, x, g, Ss = st.pre
    _, x_new, g_new, S_new = st.post
    dev = x.device
    N = x.shape[1]
    u_prev, u_cur, y = st.u_prev.double(), st.u_cur.double(), st.y.double()
    x_aux, _, ll_aux = lookahead(model, F64, x.double(), [gi.double().T for gi in g], Ss,
                                 u_prev, u_cur, y, lam, jitter)
    lw_aux = lw.double() + ll_aux
    anc = st.anc.long()
    slots = torch.arange(N - 1, device=dev) if pinned else None
    numbers = {
        "lookahead": worst_abs(st.lw_aux, lw_aux, live(lw_aux)),
        "resample": cdf_gap(torch.softmax(st.lw_aux, 0), st.draws.u_res, anc, slots),
    }
    st_w, gp_w = Worst(), [Worst() for _ in model.gps]
    stats_w = [Worst() for _ in model.gps]
    lw_new = torch.empty(N, dtype=torch.float64, device=dev)
    uvs = st.draws.uvs
    for b in blocks(N):
        a = anc[b]
        xr, gr, Sr = advance(model, F64, x_aux, Ss, a, st.draws.z[:, b],
                             [(u[:, b], v[:, b]) for u, v in uvs], u_cur, lam, jitter)
        keep = torch.ones(a.shape[0], dtype=torch.bool, device=dev)
        if pinned and b.stop == N:  # the pinned slot: its own x', g'
            keep[-1] = False
            xr[:, -1] = x_new[:, -1].double()
            for i, gp in enumerate(model.gps):
                gr[i][-1] = g_new[i][:, -1].double()
                st_pin = mniw.unpack(Ss[i][:, anc[-1:]].double(), gp.m, gp.n)
                d = mniw.suff(F64, gr[i][-1:], model.phi(i, xr[:, -1:], u_cur))
                Sr[i][:, -1:] = mniw.pack(mniw.Stats(*(lam * p + q for p, q in zip(st_pin, d))))
        st_w.add(x_new[:, b][:, keep], xr[:, keep])
        for i in range(len(model.gps)):
            gp_w[i].add(g_new[i][:, b][:, keep], gr[i].T[:, keep])
            stats_w[i].add(S_new[i][:, b], Sr[i])
        lw_new[b] = model.loglik(y, xr, u_cur, gr) - ll_aux[a]
    numbers["state"] = st_w.rel()
    numbers["gp_value"] = max(gw.rel() for gw in gp_w)
    numbers["stats"] = max(sw.rel() for sw in stats_w)
    numbers["log_weight"] = worst_abs(st.post[0], lw_new, live(lw_new))
    return numbers, lw_new


def judge_step(model, st: Step, moments, lam, jitter):
    """The numbers of one online APF step: :func:`judge_filter`'s and
    ``moments`` (:func:`moments_gap`)."""
    numbers, _ = judge_filter(model, st, lam, jitter)
    numbers["moments"] = moments_gap(moments, st.post)
    return numbers


def judge_init(model, carry, u0):
    """The initial carry's statistics against ``suff(g0, phi(x0))`` of its
    own states and GP values (the worst packed row), and its log weights,
    which have to be 0."""
    lw, x, g, Ss = carry
    worst = 0.0
    for i, gp in enumerate(model.gps):
        w = Worst()
        phi = model.phi(i, x.double(), u0.double())
        w.add(Ss[i], mniw.pack(mniw.suff(F64, g[i].double().T, phi)))
        worst = max(worst, w.rel())
    return worst + (math.inf if bool((lw != 0).any()) else 0.0)


def systematic_in(ar: Arith, w, u):
    """:func:`systematic` with the CDF of the weights as ``ar`` reads them
    (TF32 operands: each weight rounded to TF32)."""
    return systematic(mniw.round_tf32(w.float()) if ar.tf32 else w, u)


def control_step(model, ar: Arith, pre, draws, y, u_prev, u_cur, lam, jitter):
    """The reference put in the program's place: one step in ``ar`` from
    the carry ``pre``, resampled by its own weights. Returns the new
    carry, its moments, the ancestors and the first-stage log weights, in
    the program's layout."""
    lw, x, g, Ss = pre
    xa, u_prev, u_cur, y = ar(x), ar(u_prev), ar(u_cur), ar(y)
    x_aux, _, ll_aux = lookahead(model, ar, xa, [ar(gi).T for gi in g], Ss, u_prev, u_cur,
                                 y, lam, jitter)
    lw_aux = ar(lw) + ll_aux
    anc = systematic_in(ar, torch.softmax(lw_aux, 0), draws.u_res)
    N = x.shape[1]
    x_new = torch.empty_like(xa)
    g_new = [torch.empty((gp.n, N), dtype=ar.dtype, device=x.device) for gp in model.gps]
    S_new = [torch.empty_like(S, dtype=ar.dtype) for S in Ss]
    lw_new = torch.empty(N, dtype=ar.dtype, device=x.device)
    for b in blocks(N):
        a = anc[b]
        xr, gr, Sr = advance(model, ar, x_aux, Ss, a, draws.z[:, b],
                             [(u[:, b], v[:, b]) for u, v in draws.uvs], u_cur, lam, jitter)
        x_new[:, b] = xr
        for i in range(len(model.gps)):
            g_new[i][:, b] = gr[i].T
            S_new[i][:, b] = Sr[i]
        lw_new[b] = model.loglik(y, xr, u_cur, gr) - ll_aux[a]
    post = (lw_new, x_new, g_new, S_new)
    wn = torch.softmax(lw_new, 0)
    mom = (ar.mm(x_new, wn), [ar.mm(gi, wn) for gi in g_new], [ar.mm(S, wn) for S in S_new],
           1.0 / ar.mm(wn, wn))
    return post, mom, anc, lw_aux
