"""What the work of a step needs at the least: the flops and the bytes of
each hand-written kernel's launch and of the whole step, from the shapes,
and the least time on the card's published peaks.

``particle_flops``, ``packed_bytes`` and ``packed_rows`` are copies of
``chip_smoke.py``'s ``particle_flops`` and ``packed_bytes`` and of
``bipk_tpu_torch.ops.mniw.packed_rows`` as they stood when the benchmark
was written: each input is read once and each output written once, in
float32; a gather reads its distinct source columns once.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and the float32 rate outside
# the tensor cores (the kernels are float32 SIMT), at the 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
F32 = 4


def packed_rows(m: int, n: int) -> int:
    """Rows of one particle's packed MNIW statistics."""
    return m * n + m * (m + 1) // 2 + n * (n + 1) // 2 + 1


def particle_flops(m: int, n: int):
    """Flops per particle of the packed-MNIW kernel's three modes at
    ``(m, n)``: the factorize/project core (Cholesky, two forward
    substitutions, Schur complement, mean, col, logs), the draw and rank-1
    update it adds, and the log-determinant mode."""
    chol = sum((m - c) * (2 * c + 1) for c in range(m)) + 2 * m
    solves = (n + 1) * (m * (m - 1) + m)
    core = chol + solves + 2 * n * n * m + 2 * n * m + 2 * m + m
    draw = 12 * n + 2 * (m * n + m * (m + 1) // 2 + n * (n + 1) // 2 + 1)
    lbm = chol + n * (m * (m - 1) + m) + 2 * n * n * m + m + 1
    return core, draw, lbm


def packed_bytes(m: int, n: int, N: int, distinct: int | None = None):
    """Bytes each mode must move at ``(m, n)`` and N particles:
    factorize/project, draw/update (``distinct`` source columns read when
    gathered) and the log-determinants."""
    rows = packed_rows(m, n)
    prior = m * n + m * m + n * n
    fp = F32 * (N * (rows + m + n + 1 + n * n + 2) + prior)
    src = N if distinct is None else distinct
    du = F32 * (src * rows + N * (rows + m + 2 * n + n + 2 + (distinct is not None)) + prior)
    lbm = F32 * (N * (rows + 2) + prior)
    return fp, du, lbm


def least_s(flops: float, nbytes: float) -> float:
    """The least time of work on the published peaks."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def kernel_least_s(kind: str, m: int, n: int, N: int, distinct: int | None = None) -> float:
    """Least time of one launch of a hand-written kernel: ``lookahead``
    (factorize/project), ``draw`` (the gathering draw/update, at
    ``distinct`` source columns), ``logdets`` or ``resample`` (the
    systematic resampler: N weights read, N ancestors written)."""
    core, draw, lbm = particle_flops(m, n)
    fp, du, lb = packed_bytes(m, n, N, distinct)
    if kind == "lookahead":
        return least_s(core * N, fp)
    if kind == "draw":
        return least_s((core + draw) * N, du)
    if kind == "logdets":
        return least_s(lbm * N, lb)
    if kind == "resample":
        return least_s(N, 2 * F32 * N + F32)
    raise ValueError(f"unknown kernel kind {kind!r}")


def step_least_s(gps, dx: int, N: int, logdets: bool = False) -> float:
    """Least time of one filter step (``logdets``: a cSMC step, whose
    ancestor weights add the log-determinants) whatever implements it:
    per GP ``(m, n)`` its packed statistics read once and written once,
    its values written and their uniforms read, the factorization and draw
    flops (and the log-determinants'); the states read and written, the
    process noise read, the log weights read and written."""
    flops, nbytes = 0.0, 0.0
    for m, n in gps:
        core, draw, lbm = particle_flops(m, n)
        flops += N * (core + draw + (lbm if logdets else 0))
        nbytes += F32 * N * (2 * packed_rows(m, n) + n + 2 * n)
    nbytes += F32 * N * (3 * dx + 2)
    return least_s(flops, nbytes)
