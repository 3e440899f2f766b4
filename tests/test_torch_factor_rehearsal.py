"""The warp kernel's factor pair (``csrc/warp_mniw.cu``: kEmit, the
look-ahead that also writes the factor ``LW``, and kReuse, the gathered
draw that reads it) against the per-thread kernels it replaces
(``packed_mniw_kernel<24, kEmit>`` and ``factor_gather_kernel``,
``csrc/packed_mniw.cu``), bit for bit, run on the host.

The kernels are built with ``g++`` against ``tests/cuda_threads_stub.h``
as ``tests/test_torch_warp_rehearsal.py`` builds them (every CUDA thread a
host thread, ``-ffp-contract=off``: equal bits say that every output takes
the same operations in the same order). The launches go through the
wrappers' own argument paths (``cuda_kernels._factorize_project`` with
``emit_factor`` and ``cuda_kernels._factor_gather``) with the C entries:
``bipk_factorize_project_packed`` / ``bipk_draw_update_factor_gather_packed``
(the warp kernel) and their ``*_per_thread`` comparators. The factor-gather
draw of both reads the per-thread kernel's ``LW``.

One child process per set, each with its own time limit: m = 20 at n = 1
and 2 (the vehicle's width), m = 24 with n = 2, m = 9, m = 6 with n = 2;
ragged N_out != N_in; spread-out and degenerate (three distinct)
ancestors; lambda = 0.999 with a prior and lambda = 1 without one; N for
blocks of 8, 4, 2 and 1 warps on the stand-in card's 16 SMs (two
particles per warp). The per-thread outputs are also held close to the
plain versions.
"""

import ctypes

import pytest

from test_torch_warp_rehearsal import COMMON, _run, _specs, host_lib  # noqa: F401

# (m, n, N_in, N_out, lam, with prior): the look-ahead runs at N_in, the
# draw at N_out; blocks of 8 warps from 256 particles, 4 from 128, 2 from 64
FACTOR_SETS = [
    (20, 1, 300, 257, 0.999, True),
    (20, 1, 150, 150, 1.0, False),
    (20, 2, 100, 100, 1.0, False),
    (24, 2, 130, 200, 0.999, True),
    (24, 2, 40, 40, 1.0, True),
    (9, 1, 40, 33, 0.999, True),
    (6, 2, 13, 20, 1.0, True),
]

FACTOR_CHILD = COMMON + r"""
EMIT = FP + ("LW",)
for spec in sys.argv[2:]:
    m, n, n_in, n_out, lam, with_prior = spec.split(",")
    m, n, n_in, n_out, lam = int(m), int(n), int(n_in), int(n_out), float(lam)
    with_prior = with_prior == "1"
    rng = np.random.default_rng(1000 * m + 10 * n + n_in + 7)
    S, prior, p3, scale = stats(rng, m, n, n_in)
    if not with_prior:
        prior, p3 = None, 0.0
    phi_in = torch.as_tensor(rng.standard_normal((m, n_in)) * scale, dtype=torch.float32)
    phi = torch.as_tensor(rng.standard_normal((m, n_out)) * scale, dtype=torch.float32)
    u = torch.as_tensor(rng.random((n, n_out)), dtype=torch.float32)
    v = torch.as_tensor(rng.random((n, n_out)), dtype=torch.float32)
    spread = torch.as_tensor(np.sort(rng.integers(0, n_in, n_out)), dtype=torch.int32)
    few = rng.integers(0, n_in, 3)
    degenerate = torch.as_tensor(np.sort(few[rng.integers(0, 3, n_out)]), dtype=torch.int32)
    label = f"m={m} n={n} N_in={n_in} N_out={n_out} lam={lam} prior={with_prior}"

    fp = {k: ck._factorize_project(k, S, phi_in, jitter, lam, prior, m, n, True, launch=f)[1]
          for k, f in (("warp", lib.bipk_factorize_project_packed),
                       ("per_thread", lib.bipk_factorize_project_packed_per_thread))}
    same(f"emitting look-ahead {label}", EMIT, fp["warp"], fp["per_thread"])
    close(f"emitting look-ahead {label}", EMIT, fp["per_thread"],
          ck.factorize_project_packed_plain(S, phi_in, jitter, lam, prior, m, n, True), 1e-3)
    LW = fp["per_thread"][5]
    for kind, anc in (("spread", spread), ("degenerate", degenerate)):
        du = {k: ck._factor_gather(k, S, LW, anc, phi, u, v, lam, prior, p3, m, n, launch=f)[1]
              for k, f in (("warp", lib.bipk_draw_update_factor_gather_packed),
                           ("per_thread", lib.bipk_draw_update_factor_gather_packed_per_thread))}
        same(f"factor-gather draw, {kind} ancestors, {label}", DU, du["warp"], du["per_thread"])
        close(f"factor-gather draw, {kind} ancestors, {label}", DU, du["per_thread"],
              ck.draw_update_factor_gather_packed_blocks_plain(
                  S, LW, anc, phi, u, v, jitter, lam, prior, p3, m, n), 1e-3)
print("factor pair bitwise equal", flush=True)
"""


@pytest.mark.parametrize("spec", FACTOR_SETS, ids=lambda s: "m{}n{}_{}to{}_lam{}_{}".format(
    *s[:5], "prior" if s[5] else "none"))
def test_warp_factor_pair_equals_the_per_thread_kernels_bit_for_bit(host_lib, spec):
    """The warp kEmit against ``<24, kEmit>`` (the look-ahead's outputs and
    ``LW``) and the warp kReuse against ``factor_gather_kernel`` on that
    ``LW`` (``S_new``, ``y``, both log-determinants), each draw with
    spread-out and degenerate ancestors; the per-thread outputs against
    the plain versions at 1e-3 (``S_new`` 1e-4)."""
    _run(FACTOR_CHILD, host_lib, _specs([spec]), "factor pair bitwise equal")


def test_warp_factor_pair_plan_and_widths(host_lib):
    """``bipk_warp_mniw_plan`` for the factor pair on the stand-in card (16
    SMs): kEmit plans as the look-ahead does; kReuse's tile adds LW's rows
    and keeps no triangle (v and the log-diagonal per particle); both
    refuse m > 24, which the entries refuse too."""
    lib = ctypes.CDLL(str(host_lib))

    def plan(mode, m, n, N):
        out = [ctypes.c_int() for _ in range(3)]
        rc = lib.bipk_warp_mniw_plan(mode, m, n, N, *map(ctypes.byref, out))
        return rc, tuple(o.value for o in out)

    project, logdets, emit, reuse = 0, 2, 3, 5
    assert plan(emit, 20, 1, 300) == plan(project, 20, 1, 300)
    assert plan(emit, 24, 2, 40) == plan(project, 24, 2, 40)
    for m, n, N, warps in ((20, 1, 300, 8), (20, 1, 150, 4), (24, 2, 100, 2), (9, 1, 33, 1)):
        P = 2 * warps
        rows = m * n + m * (m + 1) // 2 + n * (n + 1) // 2 + 1
        tile = (rows + m + m * (m + 1) // 2 + m * n) * (P | 1)
        floats = (m | 1) + m
        floats += (48 - floats % 32) % 32
        assert plan(reuse, m, n, N) == (0, (warps, P, 4 * (tile + P * floats) + 4 * P))
    for mode in (emit, reuse):
        assert plan(mode, 25, 1, 300)[0] != 0
        assert plan(mode, 24, 3, 300)[0] != 0
    assert plan(project, 41, 1, 300)[0] == 0 and plan(logdets, 48, 2, 300)[0] == 0
    # mode 10 is no mode of the warp kernel (kFactor, 4, and
    # kLogdetsUnpacked, 9, are ones since the unpacked factorization and
    # log-determinants moved onto it: test_torch_unpacked_rehearsal.py)
    assert plan(10, 20, 1, 300)[0] != 0
    refused = lib.bipk_draw_update_factor_gather_packed(
        None, None, 8, None, 8, None, None, None, None, ctypes.c_float(0.0), 25, 1,
        ctypes.c_float(1.0), None, None, None, None)
    assert refused != 0
