"""Wrappers, loader and launch counters of the port's CUDA kernels.

Each wrapper is named after the TPU launcher in
``bipk_tpu/ops/pallas_kernels.py`` whose work it does, and takes the same
arguments minus the TPU's tiling plan:

=========================================== =========================
wrapper                                     CUDA source
=========================================== =========================
``factorize_project_packed``                ``csrc/packed_mniw.cu``,
                                            ``csrc/warp_mniw.cu``
``systematic_ancestors_blocks``             ``csrc/systematic.cu``
``draw_update_packed_blocks``               ``csrc/packed_mniw.cu``,
                                            ``csrc/warp_mniw.cu``
``draw_update_gather_packed_blocks``        ``csrc/packed_mniw.cu``,
                                            ``csrc/warp_mniw.cu``
``log_base_measure_packed_logdets``         ``csrc/packed_mniw.cu``,
                                            ``csrc/warp_mniw.cu``
``draw_update_factor_gather_packed_blocks`` ``csrc/packed_mniw.cu``,
                                            ``csrc/warp_mniw.cu``
``draw_update_dedup_gather_packed_blocks``  ``csrc/dedup_gather.cu``
``factorize_blocks``                        ``csrc/unpacked_mniw.cu``
``factorize_project_blocks``                ``csrc/unpacked_mniw.cu``
``project_blocks``                          ``csrc/unpacked_mniw.cu``
``log_base_measure_logdets``                ``csrc/unpacked_mniw.cu``
=========================================== =========================

Each wrapper's plain version is the ``*_plain`` function beside it (a thin
adapter over :mod:`~bipk_tpu_torch.ops.mniw` / :mod:`~bipk_tpu_torch.ops.
resampling`). A wrapper given CPU tensors computes its plain version; given
CUDA tensors it launches its kernel (building the library on first use) or
raises — there is no fallback on the card. Callers that want the plain
versions on the card (to hold the kernels against them) call the
``*_plain`` functions themselves. Each wrapper counts its kernel launches
in its ``launches`` attribute; the packed-MNIW ones (``PACKED_MNIW``) also
count them per kernel instantiation (``launches_by_kernel``, keyed by
the width that serves m: ``<24>`` for m <= 24, the counterpart of the
TPU's tiled kernels, ``<48>`` for 24 < m <= 48, the counterpart of its
cs-layout ``_cs_call`` / ``_cs_du_gather_call``). The look-ahead, the
draw and the log-determinants run the warp-per-particle
``warp_mniw_kernel`` (``csrc/warp_mniw.cu``) at both widths, counted as
``"<24w>"`` and ``"<48w>"``; so does the factor pair at m <= 24, the
factor-emitting projection counted as ``"[emit]<24w>"``. The per-thread
``<24>`` and ``<48>`` look-ahead, draw and log-determinants, ``<24,
kEmit>`` and ``factor_gather_kernel`` stay compiled as the warp kernels'
comparator (``*_per_thread`` below, counted as ``"<24>"`` / ``"<48>"`` /
``"[emit]<24>"``), which no wrapper calls. The factor pair and the dedup
gather take m <= 24 only. The resampler's wrapper launches the one-block scan
kernel (``systematic_scan_kernel``); the per-thread kernel it replaced
stays as its comparator (:func:`systematic_ancestors_blocks_per_thread`,
counted as ``"_per_thread"``), which no wrapper calls either.
The four unpacked wrappers
(``UNPACKED``) take structured or flat ``T0, T1, T2`` leaves, or a given
factor, and count their launches per instantiation too; they serve
m <= 48 where the JAX package's ``factorize_blocks`` and ``project_blocks``
stop at 24. The kernels take f32 only, launch on the current stream and
never synchronise; the wrapper allocates the outputs.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from bipk_tpu_torch.ops import _build, mniw, resampling

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    "bipk_factorize_project_packed": [
        _P, _P, _P, _I, _I, _I, _F, _F, _P, _P, _P, _P, _P, _P,
    ],
    "bipk_draw_update_packed": [
        _P, _I, _P, _I, _P, _P, _P, _P, _F, _I, _I, _F, _F, _P, _P, _P, _P,
    ],
    "bipk_draw_update_factor_gather_packed": [
        _P, _P, _I, _P, _I, _P, _P, _P, _P, _F, _I, _I, _F, _P, _P, _P, _P,
    ],
    "bipk_draw_update_factor_gather_packed_per_thread": [
        _P, _P, _I, _P, _I, _P, _P, _P, _P, _F, _I, _I, _F, _P, _P, _P, _P,
    ],
    "bipk_draw_update_dedup_gather_packed": [
        _P, _I, _P, _I, _P, _P, _P, _P, _F, _I, _I, _F, _F, _P, _P, _P, _P,
    ],
    "bipk_systematic_ancestors": [_P, _P, _I, _I, _P, _P],
    "bipk_systematic_ancestors_per_thread": [_P, _P, _I, _P, _P, _P],
    "bipk_log_base_measure_packed": [_P, _P, _I, _I, _I, _F, _P, _P],
    "bipk_factorize_project_packed_per_thread": [
        _P, _P, _P, _I, _I, _I, _F, _F, _P, _P, _P, _P, _P, _P,
    ],
    "bipk_draw_update_packed_per_thread": [
        _P, _I, _P, _I, _P, _P, _P, _P, _F, _I, _I, _F, _F, _P, _P, _P, _P,
    ],
    "bipk_log_base_measure_packed_per_thread": [_P, _P, _I, _I, _I, _F, _P, _P],
    "bipk_warp_mniw_plan": [_I, _I, _I, _I, _P, _P, _P],
    "bipk_factorize_blocks": [_P, _P, _P, _P, _I, _I, _I, _F, _F, _P, _P, _P, _P],
    "bipk_factorize_project_blocks": [
        _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _P, _P, _P, _P, _P,
    ],
    "bipk_log_base_measure_logdets": [_P, _P, _P, _I, _I, _I, _F, _P, _P],
    "bipk_project_blocks": [_P, _L, _L, _P, _L, _L, _P, _I, _I, _I, _P, _P, _P],
}
MAX_M = 48
MAX_N = 2
# the m bounds of packed_mniw_kernel's instantiations (packed_mniw.cu launch)
WIDTHS = (24, 48)
# the widest m of the dedup gather (dedup_gather.cu), and its shared-memory
# stage in floats per block (kStageFloats there): a block stages its D
# distinct ancestor columns when D * packed_rows(m, n) fits
DEDUP_MAX_M = 24
DEDUP_STAGE_FLOATS = 6144


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def _on_cuda(name: str, x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raise otherwise."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {x.device}")


def _require(name: str, device, dtype, **tensors) -> None:
    for arg, (t, shape) in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _count(fn, m: int | None = None, mode: str = "", per_thread: bool = False) -> None:
    """One launch of ``fn``'s kernel; with ``m``, also of the kernel
    instantiation that serves it, keyed like ``"<24>"``, ``"<24w>"`` /
    ``"<48w>"`` (the warp kernels of the ``WARP`` wrappers) or, with
    ``mode`` ``"[emit]"``, ``"[emit]<24w>"``; ``per_thread``: the
    per-thread comparator, ``"<24>"`` / ``"<48>"`` / ``"[emit]<24>"``, or
    for the resampler (no ``m``) ``"_per_thread"`` beside its scan
    kernel's ``""``."""
    fn.launches += 1
    if m is not None:
        width = next(w for w in WIDTHS if m <= w)
        warp = "w" if fn in WARP and not per_thread else ""
        fn.launches_by_kernel[f"{mode}<{width}{warp}>"] += 1
    elif fn in PER_INSTANTIATION:
        fn.launches_by_kernel["_per_thread" if per_thread else ""] += 1


def _check_mn(name: str, S: torch.Tensor, m: int, n: int, max_m: int = MAX_M) -> None:
    if not (1 <= m <= max_m and 1 <= n <= MAX_N):
        raise ValueError(f"{name}: needs 1 <= m <= {max_m}, 1 <= n <= {MAX_N}; got m={m}, n={n}")
    if S.dim() != 2 or S.shape[0] != mniw.packed_rows(m, n):
        raise ValueError(f"{name}: S must be (packed_rows(m, n), N); got {tuple(S.shape)}")


def _prior_buffer(name, prior, m, n, S):
    """The unbatched prior ``(P0, P1, P2)`` as one ``[P0|P1|P2]`` f32
    buffer on S's device, or None."""
    if prior is None:
        return None
    P0, P1, P2 = prior
    _require(name, S.device, torch.float32,
             P0=(P0, (m, n)), P1=(P1, (m, m)), P2=(P2, (n, n)))
    return torch.cat([P0.reshape(-1), P1.reshape(-1), P2.reshape(-1)])


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _prior_mniw(prior, p3, like):
    if prior is None:
        return None
    return mniw.MNIW(*prior, torch.as_tensor(p3, dtype=like.dtype, device=like.device))


def factorize_project_packed_plain(
    S, phi, jitter, lam=1.0, prior=None, m=0, n=0, emit_factor=False
):
    """Plain PyTorch version of :func:`factorize_project_packed`."""
    out = mniw.factorize_project_packed_bl(
        S, phi, prior=_prior_mniw(prior, 0.0, S), lam=lam, m=m, n=n,
        jitter=jitter, emit_factor=emit_factor,
    )
    if emit_factor:
        return (*out[0][:5], out[1])
    return out[:5]


def factorize_project_packed(
    S: torch.Tensor, phi: torch.Tensor, jitter: float, lam: float = 1.0,
    prior: Sequence[torch.Tensor] | None = None, m: int = 0, n: int = 0,
    emit_factor: bool = False,
):
    """Factor ``prior + lam * S`` per particle and project at ``phi``.

    ``S (rows, N)`` packed statistics, ``phi (m, N)``, ``prior`` the
    unbatched ``(P0, P1, P2)`` or None -> ``(mean (n, N), col_scale (N,),
    row_scale (n, n, N), logdet_T1 (N,), logdet_Psi (N,))``. With
    ``emit_factor`` (m <= 24) a sixth output ``LW (m(m+1)/2 + m*n, N)``
    carries the factor for :func:`draw_update_factor_gather_packed_blocks`:
    rows ``[tril(L) row-major | white = L^{-1}(P0 + lam T0), row i*n + c]``
    (the warp kernel's kEmit mode).
    """
    name = "factorize_project_packed"
    _check_mn(name, S, m, n, mniw.FACTOR_MAX_M if emit_factor else MAX_M)
    if not _on_cuda(name, S):
        return factorize_project_packed_plain(S, phi, jitter, lam, prior, m, n, emit_factor)
    rc, out = _factorize_project(name, S, phi, jitter, lam, prior, m, n, emit_factor)
    _count(factorize_project_packed, m, "[emit]" if emit_factor else "")
    _check(rc, name)
    return out if emit_factor else out[:5]


def _factorize_project(name, S, phi, jitter, lam, prior, m, n, emit_factor=False, launch=None):
    """Check, allocate and launch a look-ahead kernel with the C signature
    of ``bipk_factorize_project_packed`` (the default ``launch``); the
    outputs end with ``LW``, None without ``emit_factor``."""
    if launch is None:
        launch = _lib().bipk_factorize_project_packed
    N = S.shape[1]
    _require(name, S.device, torch.float32, S=(S, S.shape), phi=(phi, (m, N)))
    pbuf = _prior_buffer(name, prior, m, n, S)
    mean = torch.empty((n, N), dtype=S.dtype, device=S.device)
    col = torch.empty((N,), dtype=S.dtype, device=S.device)
    row = torch.empty((n, n, N), dtype=S.dtype, device=S.device)
    ld = torch.empty((2, N), dtype=S.dtype, device=S.device)
    lw = (torch.empty((mniw.lw_rows(m, n), N), dtype=S.dtype, device=S.device)
          if emit_factor else None)
    rc = launch(
        S.data_ptr(), phi.data_ptr(), _ptr(pbuf), N, m, n, float(jitter),
        float(lam), mean.data_ptr(), col.data_ptr(), row.data_ptr(),
        ld.data_ptr(), _ptr(lw), _stream(S.device),
    )
    return rc, (mean, col, row, ld[0], ld[1], lw)


def systematic_ancestors_blocks_plain(w, u, n):
    """Plain PyTorch version of :func:`systematic_ancestors_blocks`."""
    return resampling.systematic(w, u)


def systematic_ancestors_blocks(w: torch.Tensor, u: torch.Tensor, n: int, *,
                                resident: bool | None = None):
    """Sorted systematic-resampling ancestors ``(n,)`` int32 from the
    unnormalized non-log weights ``w (n,)`` and the uniform ``u`` (a
    one-element tensor on w's device). On the card the kernel keeps the
    weights and its rank array in shared memory where they fit (the
    resident layout) and streams them otherwise; ``resident`` names the
    layout instead, to time the two against each other (the same
    ancestors; ``True`` raises where it does not fit)."""
    name = "systematic_ancestors_blocks"
    _check_weights(name, w, n)
    if not _on_cuda(name, w):
        return systematic_ancestors_blocks_plain(w, u, n)
    layout = -1 if resident is None else int(resident)
    rc, anc = _systematic(name, w, u, n, _lib().bipk_systematic_ancestors, layout)
    _count(systematic_ancestors_blocks)
    _check(rc, name)
    return anc


def systematic_ancestors_blocks_per_thread(w: torch.Tensor, u: torch.Tensor, n: int):
    """:func:`systematic_ancestors_blocks` through the per-thread kernel the
    scan kernel replaced (``systematic_kernel_per_thread``): the same
    ancestors, which the scan kernel must equal bit for bit. Counted as
    ``"_per_thread"`` of :func:`systematic_ancestors_blocks`; no wrapper
    calls it."""
    name = "systematic_ancestors_blocks_per_thread"
    _check_weights(name, w, n)
    if not _on_cuda(name, w):
        raise ValueError(f"{name}: the per-thread comparator runs on a CUDA tensor only")
    rc, anc = _systematic(name, w, u, n, _lib().bipk_systematic_ancestors_per_thread)
    _count(systematic_ancestors_blocks, per_thread=True)
    _check(rc, name)
    return anc


def _check_weights(name, w, n):
    if w.dim() != 1 or w.shape[0] != n or n < 1:
        raise ValueError(f"{name}: w must be ({n},); got {tuple(w.shape)}")


def _systematic(name, w, u, n, launch, layout=None):
    """Check and launch a resampler through the C entry ``launch``: with a
    ``layout`` (-1 by n, 0 streamed, 1 resident), that of
    ``bipk_systematic_ancestors``; without, its per-thread comparator's,
    which takes an n-int scratch for the cumulative counts instead.
    Returns ``(rc, anc)``."""
    u1 = u.reshape(1)
    _require(name, w.device, torch.float32, w=(w, (n,)), u=(u1, (1,)))
    anc = torch.empty((n,), dtype=torch.int32, device=w.device)
    if layout is None:
        cc = torch.empty((n,), dtype=torch.int32, device=w.device)
        rc = launch(w.data_ptr(), u1.data_ptr(), n, cc.data_ptr(), anc.data_ptr(),
                    _stream(w.device))
    else:
        rc = launch(w.data_ptr(), u1.data_ptr(), n, layout, anc.data_ptr(), _stream(w.device))
    return rc, anc


def _draw_update(name, S, anc, phi, u, v, jitter, lam, prior, p3, m, n, launch=None):
    """Check, allocate and launch a draw/update kernel with the C
    signature of ``bipk_draw_update_packed`` (the default ``launch``)."""
    if launch is None:
        launch = _lib().bipk_draw_update_packed
    n_in = S.shape[1]
    n_out = n_in if anc is None else anc.shape[0]
    _require(
        name, S.device, torch.float32, S=(S, S.shape), phi=(phi, (m, n_out)),
        u=(u, (n, n_out)), v=(v, (n, n_out)),
    )
    if anc is not None:
        _require(name, S.device, torch.int32, ancestors=(anc, (n_out,)))
    pbuf = _prior_buffer(name, prior, m, n, S)
    S_new = torch.empty((S.shape[0], n_out), dtype=S.dtype, device=S.device)
    y = torch.empty((n, n_out), dtype=S.dtype, device=S.device)
    ld = torch.empty((2, n_out), dtype=S.dtype, device=S.device)
    rc = launch(
        S.data_ptr(), n_in, _ptr(anc), n_out, phi.data_ptr(), u.data_ptr(),
        v.data_ptr(), _ptr(pbuf), float(p3), m, n, float(jitter), float(lam),
        S_new.data_ptr(), y.data_ptr(), ld.data_ptr(), _stream(S.device),
    )
    return rc, (S_new, y, ld[0], ld[1])


def draw_update_packed_blocks_plain(
    S, phi, u, v, jitter, lam=1.0, prior=None, p3=0.0, m=0, n=0
):
    """Plain PyTorch version of :func:`draw_update_packed_blocks`."""
    return mniw.draw_update_packed_bl(
        u, v, S, phi, prior=_prior_mniw(prior, p3, S), lam=lam, m=m, n=n,
        jitter=jitter,
    )


def draw_update_packed_blocks(
    S: torch.Tensor, phi: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
    jitter: float, lam: float = 1.0,
    prior: Sequence[torch.Tensor] | None = None, p3: float = 0.0,
    m: int = 0, n: int = 0,
):
    """Matrix-t predictive draw + rank-1 statistics update.

    ``S (rows, N)``, ``phi (m, N)``, raw uniforms ``u, v (n, N)``, prior
    ``(P0, P1, P2)`` and its scalar ``p3`` -> ``(S_new (rows, N), y (n, N),
    logdet_T1 (N,), logdet_Psi (N,))``; ``S_new`` is a new buffer.
    """
    name = "draw_update_packed_blocks"
    _check_mn(name, S, m, n)
    if not _on_cuda(name, S):
        return draw_update_packed_blocks_plain(
            S, phi, u, v, jitter, lam, prior, p3, m, n
        )
    rc, out = _draw_update(name, S, None, phi, u, v, jitter, lam, prior, p3, m, n)
    _count(draw_update_packed_blocks, m)
    _check(rc, name)
    return out


def draw_update_gather_packed_blocks_plain(
    S, ancestors, phi, u, v, jitter, lam=1.0, prior=None, p3=0.0, m=0, n=0
):
    """Plain PyTorch version of :func:`draw_update_gather_packed_blocks`:
    the gather, then the draw/update."""
    return mniw.draw_update_packed_bl(
        u, v, S.index_select(1, ancestors), phi,
        prior=_prior_mniw(prior, p3, S), lam=lam, m=m, n=n, jitter=jitter,
    )


def draw_update_gather_packed_blocks(
    S: torch.Tensor, ancestors: torch.Tensor, phi: torch.Tensor,
    u: torch.Tensor, v: torch.Tensor, jitter: float, lam: float = 1.0,
    prior: Sequence[torch.Tensor] | None = None, p3: float = 0.0,
    m: int = 0, n: int = 0,
):
    """:func:`draw_update_packed_blocks` on ``S[:, ancestors]``, the gather
    done inside the kernel. ``ancestors (N_out,)`` int32, sorted, with
    values in ``[0, N_in)``; ``phi, u, v`` and the outputs have ``N_out``
    columns."""
    name = "draw_update_gather_packed_blocks"
    _check_mn(name, S, m, n)
    if not _on_cuda(name, S):
        return draw_update_gather_packed_blocks_plain(
            S, ancestors, phi, u, v, jitter, lam, prior, p3, m, n
        )
    rc, out = _draw_update(name, S, ancestors, phi, u, v, jitter, lam, prior, p3, m, n)
    _count(draw_update_gather_packed_blocks, m)
    _check(rc, name)
    return out


def draw_update_factor_gather_packed_blocks_plain(
    S, LW, ancestors, phi, u, v, jitter, lam=1.0, prior=None, p3=0.0, m=0, n=0
):
    """Plain PyTorch version of :func:`draw_update_factor_gather_packed_blocks`:
    the factor is read from ``LW``, not computed (``jitter`` is in it)."""
    return mniw.draw_update_factor_gather_packed_bl(
        u, v, S, LW, ancestors, phi, prior=_prior_mniw(prior, p3, S),
        lam=lam, m=m, n=n,
    )


def draw_update_factor_gather_packed_blocks(
    S: torch.Tensor, LW: torch.Tensor, ancestors: torch.Tensor,
    phi: torch.Tensor, u: torch.Tensor, v: torch.Tensor, jitter: float,
    lam: float = 1.0, prior: Sequence[torch.Tensor] | None = None,
    p3: float = 0.0, m: int = 0, n: int = 0,
):
    """:func:`draw_update_gather_packed_blocks` reusing the factor
    ``LW (m(m+1)/2 + m*n, N_in)`` that :func:`factorize_project_packed`
    emitted for the same ``S``, ``prior`` and ``lam`` (m <= 24): particle
    j reads ``S[:, anc[j]]`` and ``LW[:, anc[j]]`` and forward-substitutes
    ``phi``, with no Cholesky (the warp kernel's kReuse mode). ``jitter``
    is already in ``LW``; it is taken for the signature of the refactoring
    wrapper and not read."""
    name = "draw_update_factor_gather_packed_blocks"
    _check_factor_gather(name, S, LW, m, n)
    if not _on_cuda(name, S):
        return draw_update_factor_gather_packed_blocks_plain(
            S, LW, ancestors, phi, u, v, jitter, lam, prior, p3, m, n
        )
    rc, out = _factor_gather(name, S, LW, ancestors, phi, u, v, lam, prior, p3, m, n)
    _count(draw_update_factor_gather_packed_blocks, m)
    _check(rc, name)
    return out


def _check_factor_gather(name, S, LW, m, n):
    _check_mn(name, S, m, n, mniw.FACTOR_MAX_M)
    if LW.dim() != 2 or tuple(LW.shape) != (mniw.lw_rows(m, n), S.shape[1]):
        raise ValueError(f"{name}: LW must be ({mniw.lw_rows(m, n)}, {S.shape[1]}) "
                         f"(lw_rows(m, n), N_in); got {tuple(LW.shape)}")


def _factor_gather(name, S, LW, anc, phi, u, v, lam, prior, p3, m, n, launch=None):
    """Check, allocate and launch a factor-gather draw with the C
    signature of ``bipk_draw_update_factor_gather_packed`` (the default
    ``launch``): ``(rc, (S_new, y, logdet_T1, logdet_Psi))``."""
    if launch is None:
        launch = _lib().bipk_draw_update_factor_gather_packed
    n_in, n_out = S.shape[1], anc.shape[0]
    _require(
        name, S.device, torch.float32, S=(S, S.shape), LW=(LW, LW.shape),
        phi=(phi, (m, n_out)), u=(u, (n, n_out)), v=(v, (n, n_out)),
    )
    _require(name, S.device, torch.int32, ancestors=(anc, (n_out,)))
    pbuf = _prior_buffer(name, prior, m, n, S)
    S_new = torch.empty((S.shape[0], n_out), dtype=S.dtype, device=S.device)
    y = torch.empty((n, n_out), dtype=S.dtype, device=S.device)
    ld = torch.empty((2, n_out), dtype=S.dtype, device=S.device)
    rc = launch(
        S.data_ptr(), LW.data_ptr(), n_in, anc.data_ptr(), n_out,
        phi.data_ptr(), u.data_ptr(), v.data_ptr(), _ptr(pbuf), float(p3), m,
        n, float(lam), S_new.data_ptr(), y.data_ptr(), ld.data_ptr(),
        _stream(S.device),
    )
    return rc, (S_new, y, ld[0], ld[1])


def draw_update_dedup_gather_packed_blocks_plain(
    S, ancestors, phi, u, v, jitter, lam=1.0, prior=None, p3=0.0, m=0, n=0
):
    """Plain PyTorch version of :func:`draw_update_dedup_gather_packed_blocks`:
    the gather, then the draw/update, as for the gather/draw kernel."""
    return draw_update_gather_packed_blocks_plain(
        S, ancestors, phi, u, v, jitter, lam, prior, p3, m, n
    )


def draw_update_dedup_gather_packed_blocks(
    S: torch.Tensor, ancestors: torch.Tensor, phi: torch.Tensor,
    u: torch.Tensor, v: torch.Tensor, jitter: float, lam: float = 1.0,
    prior: Sequence[torch.Tensor] | None = None, p3: float = 0.0,
    m: int = 0, n: int = 0,
):
    """:func:`draw_update_gather_packed_blocks` for degenerate weights
    (m <= 24): each block of 128 outputs stages its distinct ancestor
    columns in shared memory once when they fit ``DEDUP_STAGE_FLOATS``,
    and reads them from global memory as the gather/draw kernel does
    when not. Same contract and result."""
    name = "draw_update_dedup_gather_packed_blocks"
    _check_mn(name, S, m, n, DEDUP_MAX_M)
    if not _on_cuda(name, S):
        return draw_update_dedup_gather_packed_blocks_plain(
            S, ancestors, phi, u, v, jitter, lam, prior, p3, m, n
        )
    rc, out = _draw_update(name, S, ancestors, phi, u, v, jitter, lam, prior, p3, m, n,
                           _lib().bipk_draw_update_dedup_gather_packed)
    _count(draw_update_dedup_gather_packed_blocks, m)
    _check(rc, name)
    return out


def dedup_staged_blocks(ancestors: torch.Tensor, m: int, n: int):
    """``(staged, direct)``: how many blocks of 128 outputs of
    :func:`draw_update_dedup_gather_packed_blocks` stage their distinct
    ancestor columns (D * packed_rows(m, n) <= DEDUP_STAGE_FLOATS, D the
    block's count of runs of equal ancestors) and how many read directly,
    by the rule of ``dedup_gather.cu``. For reports; the kernel decides
    on the device."""
    a = ancestors.long()
    starts = torch.ones_like(a, dtype=torch.bool)
    starts[1:] = a[1:] != a[:-1]
    starts[::128] = True
    runs = torch.zeros(-(-a.shape[0] // 128), dtype=torch.long, device=a.device)
    runs.index_add_(0, torch.arange(a.shape[0], device=a.device) // 128, starts.long())
    staged = int((runs * mniw.packed_rows(m, n) <= DEDUP_STAGE_FLOATS).sum())
    return staged, runs.shape[0] - staged


def log_base_measure_packed_logdets_plain(S, jitter, prior=None, m=0, n=0):
    """Plain PyTorch version of :func:`log_base_measure_packed_logdets`."""
    return mniw.packed_logdets_bl(
        S, _prior_mniw(prior, 0.0, S), m, n, jitter=jitter
    )


def log_base_measure_packed_logdets(
    S: torch.Tensor, jitter: float,
    prior: Sequence[torch.Tensor] | None = None, m: int = 0, n: int = 0,
):
    """``(logdet_T1 (N,), logdet_Psi (N,))`` of ``prior + S`` per particle
    (``lam = 1``, relative jitter on the diagonal of ``T1``).

    ``S (rows, N)`` packed statistics, ``prior`` the unbatched ``(P0, P1,
    P2)`` (e.g. the prior plus the cSMC reference's future statistics) or
    None. The degrees of freedom stay outside: the caller adds them to the
    log base measure (:func:`~bipk_tpu_torch.ops.mniw.
    log_base_measure_packed_bl`).
    """
    name = "log_base_measure_packed_logdets"
    _check_mn(name, S, m, n)
    if not _on_cuda(name, S):
        return log_base_measure_packed_logdets_plain(S, jitter, prior, m, n)
    rc, out = _logdets(name, S, jitter, prior, m, n, _lib().bipk_log_base_measure_packed)
    _count(log_base_measure_packed_logdets, m)
    _check(rc, name)
    return out


def _logdets(name, S, jitter, prior, m, n, launch):
    """The log-determinants' launch through the C entry ``launch``
    (``bipk_log_base_measure_packed`` or its comparator): ``(rc,
    (logdet_T1, logdet_Psi))``."""
    N = S.shape[1]
    _require(name, S.device, torch.float32, S=(S, S.shape))
    pbuf = _prior_buffer(name, prior, m, n, S)
    ld = torch.empty((2, N), dtype=S.dtype, device=S.device)
    rc = launch(S.data_ptr(), _ptr(pbuf), N, m, n, float(jitter), ld.data_ptr(),
                _stream(S.device))
    return rc, (ld[0], ld[1])


# ---------------------------------------------------------------------------
# The per-thread comparator of the warp kernels: the packed_mniw_kernel<24,
# kProject / kDraw / kLogdets> (m <= 24) and <48, ...> (24 < m <= 48), <24,
# kEmit> and factor_gather_kernel that the wrappers launched before the
# warp kernels replaced them, kept to hold the warp kernels against bit for
# bit and to time beside them. No wrapper calls these.
# ---------------------------------------------------------------------------


def _per_thread_device(name: str, S: torch.Tensor) -> None:
    if not _on_cuda(name, S):
        raise ValueError(f"{name}: the per-thread comparator runs on a CUDA tensor only")


def factorize_project_packed_per_thread(
    S: torch.Tensor, phi: torch.Tensor, jitter: float, lam: float = 1.0,
    prior: Sequence[torch.Tensor] | None = None, m: int = 0, n: int = 0,
    emit_factor: bool = False,
):
    """:func:`factorize_project_packed` through the per-thread
    ``packed_mniw_kernel<24, kProject>`` (m <= 24) or ``<48, kProject>``,
    with ``emit_factor`` ``<24, kEmit>``: the same outputs, which the warp
    kernel must equal bit for bit."""
    name = "factorize_project_packed_per_thread"
    _check_mn(name, S, m, n, mniw.FACTOR_MAX_M if emit_factor else MAX_M)
    _per_thread_device(name, S)
    rc, out = _factorize_project(name, S, phi, jitter, lam, prior, m, n, emit_factor,
                                 launch=_lib().bipk_factorize_project_packed_per_thread)
    _count(factorize_project_packed, m, "[emit]" if emit_factor else "", per_thread=True)
    _check(rc, name)
    return out if emit_factor else out[:5]


def draw_update_gather_packed_blocks_per_thread(
    S: torch.Tensor, ancestors: torch.Tensor | None, phi: torch.Tensor,
    u: torch.Tensor, v: torch.Tensor, jitter: float, lam: float = 1.0,
    prior: Sequence[torch.Tensor] | None = None, p3: float = 0.0,
    m: int = 0, n: int = 0,
):
    """:func:`draw_update_gather_packed_blocks` (``ancestors`` None:
    :func:`draw_update_packed_blocks`) through the per-thread
    ``packed_mniw_kernel<24, kDraw>`` (m <= 24) or ``<48, kDraw>``."""
    name = "draw_update_gather_packed_blocks_per_thread"
    _check_mn(name, S, m, n)
    _per_thread_device(name, S)
    rc, out = _draw_update(name, S, ancestors, phi, u, v, jitter, lam, prior, p3, m, n,
                           _lib().bipk_draw_update_packed_per_thread)
    _count(draw_update_packed_blocks if ancestors is None else draw_update_gather_packed_blocks,
           m, per_thread=True)
    _check(rc, name)
    return out


def draw_update_factor_gather_packed_blocks_per_thread(
    S: torch.Tensor, LW: torch.Tensor, ancestors: torch.Tensor,
    phi: torch.Tensor, u: torch.Tensor, v: torch.Tensor, jitter: float,
    lam: float = 1.0, prior: Sequence[torch.Tensor] | None = None,
    p3: float = 0.0, m: int = 0, n: int = 0,
):
    """:func:`draw_update_factor_gather_packed_blocks` through the
    per-thread ``factor_gather_kernel``: the same outputs, which the warp
    kernel must equal bit for bit."""
    name = "draw_update_factor_gather_packed_blocks_per_thread"
    _check_factor_gather(name, S, LW, m, n)
    _per_thread_device(name, S)
    rc, out = _factor_gather(name, S, LW, ancestors, phi, u, v, lam, prior, p3, m, n,
                             _lib().bipk_draw_update_factor_gather_packed_per_thread)
    _count(draw_update_factor_gather_packed_blocks, m, per_thread=True)
    _check(rc, name)
    return out


def log_base_measure_packed_logdets_per_thread(
    S: torch.Tensor, jitter: float,
    prior: Sequence[torch.Tensor] | None = None, m: int = 0, n: int = 0,
):
    """:func:`log_base_measure_packed_logdets` through the per-thread
    ``packed_mniw_kernel<24, kLogdets>`` (m <= 24) or ``<48, kLogdets>``:
    the same outputs, which the warp kernel must equal bit for bit."""
    name = "log_base_measure_packed_logdets_per_thread"
    _check_mn(name, S, m, n)
    _per_thread_device(name, S)
    rc, out = _logdets(name, S, jitter, prior, m, n,
                       _lib().bipk_log_base_measure_packed_per_thread)
    _count(log_base_measure_packed_logdets, m, per_thread=True)
    _check(rc, name)
    return out


# the warp kernel's modes (csrc/packed_mniw.cuh ``Mode``) by name: the
# look-ahead (the draw's plan is the same), the log-determinants, the
# factor-emitting look-ahead and the factor-gather draw
WARP_MODES = {"project": 0, "logdets": 2, "emit": 3, "reuse": 5}


def warp_plan(m: int, n: int, N: int, mode: str = "project") -> tuple[int, int, int]:
    """``(warps per block, particles per block, dynamic shared memory in
    bytes)`` of the warp kernel's launch in ``mode`` (a key of
    ``WARP_MODES``) at ``(m, n)`` and N particles on the current card, as
    ``csrc/warp_mniw.cu`` chooses them (two particles per warp at m <= 24,
    one above). For reports."""
    warps, particles, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _check(_lib().bipk_warp_mniw_plan(WARP_MODES[mode], m, n, N, ctypes.byref(warps),
                                      ctypes.byref(particles), ctypes.byref(smem)),
           "warp_plan")
    return warps.value, particles.value, smem.value


# ---------------------------------------------------------------------------
# The unpacked kernels (csrc/unpacked_mniw.cu): structured or flat
# statistics, and the projection from a given factor.
# ---------------------------------------------------------------------------


def _unpacked_mn(name, T0, T1, T2, m, n):
    """``(m, n)`` of structured (``T0 (m, n, N)``) or flat (``T0 (m*n,
    N)``, pass ``m`` and ``n``) statistics; raise outside the kernels'
    widths or on leaves of another shape."""
    if T0.dim() == 3:
        m, n = T0.shape[0], T0.shape[1]
        shapes = ((m, n), (m, m), (n, n))
    else:
        if not m or not n:
            raise ValueError(f"{name}: flat statistics need m and n")
        shapes = ((m * n,), (m * m,), (n * n,))
    if not (1 <= m <= MAX_M and 1 <= n <= MAX_N):
        raise ValueError(f"{name}: needs 1 <= m <= {MAX_M}, 1 <= n <= {MAX_N}; got m={m}, n={n}")
    N = T0.shape[-1]
    for arg, t, lead in zip(("T0", "T1", "T2"), (T0, T1, T2), shapes):
        if tuple(t.shape) != (*lead, N):
            raise ValueError(f"{name}: {arg} must be {(*lead, N)}; got {tuple(t.shape)}")
    return m, n


def _require_unpacked(name, T0, T1, T2, **tensors) -> int:
    """Check the leaves and ``tensors`` (f32, contiguous, on T0's device);
    return N."""
    _require(name, T0.device, torch.float32, T0=(T0, T0.shape), T1=(T1, T1.shape),
             T2=(T2, T2.shape), **tensors)
    return T0.shape[-1]


def factorize_blocks_plain(T0, T1, T2, jitter, lam=1.0, prior=None):
    """Plain PyTorch version of :func:`factorize_blocks`."""
    f = mniw._factorize_scaled_bl_plain(
        mniw.MNIW(T0, T1, T2, torch.zeros(T0.shape[-1], dtype=T0.dtype, device=T0.device)),
        _prior_mniw(prior, 0.0, T0), lam, jitter)
    return f.chol, f.white_T0, f.row_scale


def factorize_blocks(
    T0: torch.Tensor, T1: torch.Tensor, T2: torch.Tensor, jitter: float,
    lam: float = 1.0, prior: Sequence[torch.Tensor] | None = None,
):
    """Factor ``prior + lam * stats`` per particle: ``T0 (m, n, N)``, ``T1
    (m, m, N)``, ``T2 (n, n, N)``, ``prior`` the unbatched ``(P0, P1,
    P2)`` or None -> ``(chol (m, m, N)`` lower with zeros above the
    diagonal, ``white (m, n, N) = L^{-1}(P0 + lam T0)``, ``row (n, n, N) =
    P2 + lam T2 - white^T white)``, ``chol`` the Cholesky factor of ``P1
    + lam sym(T1)`` with the relative jitter ``jitter * trace / m`` on its
    diagonal."""
    name = "factorize_blocks"
    if T0.dim() != 3:
        raise ValueError(f"{name}: needs structured statistics, T0 (m, n, N)")
    m, n = _unpacked_mn(name, T0, T1, T2, 0, 0)
    if not _on_cuda(name, T0):
        return factorize_blocks_plain(T0, T1, T2, jitter, lam, prior)
    N = _require_unpacked(name, T0, T1, T2)
    pbuf = _prior_buffer(name, prior, m, n, T0)
    chol = torch.empty((m, m, N), dtype=T0.dtype, device=T0.device)
    white = torch.empty((m, n, N), dtype=T0.dtype, device=T0.device)
    row = torch.empty((n, n, N), dtype=T0.dtype, device=T0.device)
    rc = _lib().bipk_factorize_blocks(
        T0.data_ptr(), T1.data_ptr(), T2.data_ptr(), _ptr(pbuf), N, m, n,
        float(jitter), float(lam), chol.data_ptr(), white.data_ptr(),
        row.data_ptr(), _stream(T0.device),
    )
    _count(factorize_blocks, m)
    _check(rc, name)
    return chol, white, row


def factorize_project_blocks_plain(T0, T1, T2, phi, jitter, lam=1.0, prior=None,
                                   m=None, n=None):
    """Plain PyTorch version of :func:`factorize_project_blocks`."""
    stats = mniw.MNIW(T0, T1, T2, torch.zeros(T0.shape[-1], dtype=T0.dtype, device=T0.device))
    fp = mniw._factorize_project_bl_plain(stats, phi, _prior_mniw(prior, 0.0, T0), lam, jitter)
    return fp[:5]


def factorize_project_blocks(
    T0: torch.Tensor, T1: torch.Tensor, T2: torch.Tensor, phi: torch.Tensor,
    jitter: float, lam: float = 1.0,
    prior: Sequence[torch.Tensor] | None = None,
    m: int | None = None, n: int | None = None,
):
    """:func:`factorize_blocks` projected at ``phi (m, N)``, the factor
    never written: ``(mean (n, N), col_scale (N,), row_scale (n, n, N),
    logdet_T1 (N,), logdet_Psi (N,))``. Statistics structured, or flat
    ``(m*n, N)``, ``(m*m, N)``, ``(n*n, N)`` with ``m`` and ``n``."""
    name = "factorize_project_blocks"
    m, n = _unpacked_mn(name, T0, T1, T2, m, n)
    if not _on_cuda(name, T0):
        return factorize_project_blocks_plain(T0, T1, T2, phi, jitter, lam, prior, m, n)
    N = _require_unpacked(name, T0, T1, T2, phi=(phi, (m, T0.shape[-1])))
    pbuf = _prior_buffer(name, prior, m, n, T0)
    mean = torch.empty((n, N), dtype=T0.dtype, device=T0.device)
    col = torch.empty((N,), dtype=T0.dtype, device=T0.device)
    row = torch.empty((n, n, N), dtype=T0.dtype, device=T0.device)
    ld = torch.empty((2, N), dtype=T0.dtype, device=T0.device)
    rc = _lib().bipk_factorize_project_blocks(
        T0.data_ptr(), T1.data_ptr(), T2.data_ptr(), phi.data_ptr(), _ptr(pbuf),
        N, m, n, float(jitter), float(lam), mean.data_ptr(), col.data_ptr(),
        row.data_ptr(), ld.data_ptr(), _stream(T0.device),
    )
    _count(factorize_project_blocks, m)
    _check(rc, name)
    return mean, col, row, ld[0], ld[1]


def project_blocks_plain(chol, white, phi):
    """Plain PyTorch version of :func:`project_blocks`."""
    return mniw._project_mean_col(chol, white, phi)


def project_blocks(chol: torch.Tensor, white: torch.Tensor, phi: torch.Tensor):
    """From a given factor: ``v = chol^{-1} phi``, ``mean = white^T v``,
    ``col_scale = v.v + 1`` -> ``(mean (n, N), col_scale (N,))``.

    ``chol (m, m, N)`` (only its lower triangle is read) and ``white (m,
    n, N)`` may be strided views, e.g. of an augmented factor ``F (p, p,
    N)`` (``F[:m, :m]`` and ``F[m:, :m]`` transposed), as long as the
    particle axis has stride 1: the kernel reads them in place."""
    name = "project_blocks"
    m, n, N = white.shape[0], white.shape[1], white.shape[-1]
    if chol.dim() != 3 or tuple(chol.shape) != (m, m, N) or white.dim() != 3:
        raise ValueError(f"{name}: chol must be (m, m, N) and white (m, n, N); got "
                         f"{tuple(chol.shape)}, {tuple(white.shape)}")
    if not (1 <= m <= MAX_M and 1 <= n <= MAX_N):
        raise ValueError(f"{name}: needs 1 <= m <= {MAX_M}, 1 <= n <= {MAX_N}; got m={m}, n={n}")
    if not _on_cuda(name, chol):
        return project_blocks_plain(chol, white, phi)
    _require(name, chol.device, torch.float32, phi=(phi, (m, N)))
    for arg, t in (("chol", chol), ("white", white)):
        if t.device != chol.device or t.dtype != torch.float32:
            raise ValueError(f"{name}: {arg} must be float32 on {chol.device}")
        if N > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name}: {arg} needs particle stride 1; got {t.stride()}")
    mean = torch.empty((n, N), dtype=phi.dtype, device=phi.device)
    col = torch.empty((N,), dtype=phi.dtype, device=phi.device)
    rc = _lib().bipk_project_blocks(
        chol.data_ptr(), chol.stride(0), chol.stride(1), white.data_ptr(),
        white.stride(0), white.stride(1), phi.data_ptr(), N, m, n,
        mean.data_ptr(), col.data_ptr(), _stream(phi.device),
    )
    _count(project_blocks, m)
    _check(rc, name)
    return mean, col


def log_base_measure_logdets_plain(T0, T1, T2, jitter, m=None, n=None):
    """Plain PyTorch version of :func:`log_base_measure_logdets`."""
    nat = mniw.MNIW(T0, T1, T2, None)
    if T0.dim() == 2:
        nat = mniw.from_flat_bl(nat, m, n)
    return mniw._base_measure_logdets_plain(nat, jitter)


def log_base_measure_logdets(
    T0: torch.Tensor, T1: torch.Tensor, T2: torch.Tensor, jitter: float,
    m: int | None = None, n: int | None = None,
):
    """``(logdet sym(T1) (N,), logdet Psi (N,))`` with ``Psi = T2 - T0^T
    sym(T1)^{-1} T0`` and the relative jitter on ``sym(T1)``'s diagonal
    (no ``lam``, no prior). Statistics structured, or flat with ``m`` and
    ``n``."""
    name = "log_base_measure_logdets"
    m, n = _unpacked_mn(name, T0, T1, T2, m, n)
    if not _on_cuda(name, T0):
        return log_base_measure_logdets_plain(T0, T1, T2, jitter, m, n)
    N = _require_unpacked(name, T0, T1, T2)
    ld = torch.empty((2, N), dtype=T0.dtype, device=T0.device)
    rc = _lib().bipk_log_base_measure_logdets(
        T0.data_ptr(), T1.data_ptr(), T2.data_ptr(), N, m, n, float(jitter),
        ld.data_ptr(), _stream(T0.device),
    )
    _count(log_base_measure_logdets, m)
    _check(rc, name)
    return ld[0], ld[1]


WRAPPERS = (
    factorize_project_packed,
    systematic_ancestors_blocks,
    draw_update_packed_blocks,
    draw_update_gather_packed_blocks,
    log_base_measure_packed_logdets,
    draw_update_factor_gather_packed_blocks,
    draw_update_dedup_gather_packed_blocks,
    factorize_blocks,
    factorize_project_blocks,
    project_blocks,
    log_base_measure_logdets,
)
PLAIN = {
    factorize_project_packed: factorize_project_packed_plain,
    systematic_ancestors_blocks: systematic_ancestors_blocks_plain,
    draw_update_packed_blocks: draw_update_packed_blocks_plain,
    draw_update_gather_packed_blocks: draw_update_gather_packed_blocks_plain,
    log_base_measure_packed_logdets: log_base_measure_packed_logdets_plain,
    draw_update_factor_gather_packed_blocks: draw_update_factor_gather_packed_blocks_plain,
    draw_update_dedup_gather_packed_blocks: draw_update_dedup_gather_packed_blocks_plain,
    factorize_blocks: factorize_blocks_plain,
    factorize_project_blocks: factorize_project_blocks_plain,
    project_blocks: project_blocks_plain,
    log_base_measure_logdets: log_base_measure_logdets_plain,
}


# the wrappers whose launches run the warp kernels (all the packed-MNIW
# ones but the dedup gather; the factor pair at m <= 24 only)
WARP = (factorize_project_packed, draw_update_packed_blocks, draw_update_gather_packed_blocks,
        log_base_measure_packed_logdets, draw_update_factor_gather_packed_blocks)
# the packed-MNIW wrappers and the instantiations each launches (those of
# the WARP wrappers without "w": the per-thread comparator only)
PACKED_MNIW = {
    factorize_project_packed: ("<24w>", "<48w>", "<24>", "<48>", "[emit]<24w>", "[emit]<24>"),
    draw_update_packed_blocks: ("<24w>", "<48w>", "<24>", "<48>"),
    draw_update_gather_packed_blocks: ("<24w>", "<48w>", "<24>", "<48>"),
    log_base_measure_packed_logdets: ("<24w>", "<48w>", "<24>", "<48>"),
    draw_update_factor_gather_packed_blocks: ("<24w>", "<24>"),
    draw_update_dedup_gather_packed_blocks: ("<24>",),
}
# the unpacked wrappers (csrc/unpacked_mniw.cu), each at both widths
UNPACKED = (factorize_blocks, factorize_project_blocks, project_blocks,
            log_base_measure_logdets)
# the resampler's scan kernel ("") and per-thread comparator ("_per_thread")
PER_INSTANTIATION = {**PACKED_MNIW, **{fn: ("<24>", "<48>") for fn in UNPACKED},
                     systematic_ancestors_blocks: ("", "_per_thread")}


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
    for fn, kernels in PER_INSTANTIATION.items():
        fn.launches_by_kernel = dict.fromkeys(kernels, 0)


def launch_counts() -> dict:
    """Launches since the last :func:`reset_launch_counts`: per kernel
    instantiation for the packed-MNIW and unpacked wrappers, keyed
    ``"<wrapper><24>"``, ``"<wrapper><24w>"`` / ``"<wrapper><48w>"`` (the
    warp kernels), ``"<wrapper><48>"`` and, for the factor-emitting projection,
    ``"factorize_project_packed[emit]<24w>"`` (its per-thread comparator
    ``"...[emit]<24>"``); for the resampler
    ``"systematic_ancestors_blocks"`` (the scan kernel) and
    ``"systematic_ancestors_blocks_per_thread"`` (its comparator)."""
    out = {}
    for fn in WRAPPERS:
        if fn in PER_INSTANTIATION:
            out.update({f"{fn.__name__}{k}": c for k, c in fn.launches_by_kernel.items()})
        else:
            out[fn.__name__] = fn.launches
    return out


reset_launch_counts()
