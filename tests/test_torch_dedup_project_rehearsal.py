"""The warp kernel's dedup gather and projection from a given factor
(``csrc/warp_mniw.cu``: kDedup and kFromFactor) against the per-thread
kernels they replace (``dedup_gather_kernel``, ``csrc/dedup_gather.cu``,
and ``project_kernel<24 | 48>``, ``csrc/unpacked_mniw.cu``), bit for bit,
run on the host.

The kernels are built with ``g++`` against ``tests/cuda_threads_stub.h``
as ``tests/test_torch_warp_rehearsal.py`` builds them (every CUDA thread a
host thread, ``-ffp-contract=off``: equal bits say that every output takes
the same operations in the same order), with ``dedup_gather.cu`` and
``unpacked_mniw.cu`` beside them (the per-thread dedup kernel's static
``__shared__`` arrays become ``static`` ones: the stub runs one block at a
time). The launches go through the wrappers' own argument paths
(``cuda_kernels._draw_update`` and ``cuda_kernels._project``) with the C
entries: ``bipk_draw_update_dedup_gather_packed`` /
``bipk_project_blocks`` (the warp kernel) and their ``*_per_thread``
comparators.

One child process per set, each with its own time limit (a group of sets
runs its children one after another), and each prints its set before it
starts it. The dedup sets:
m = 20 at n = 1 and 2 (the vehicle's width), m = 24 with n = 2, m = 9,
m = 6 with n = 2; ragged N_out != N_in; a resampler's ancestors on
degenerate weights (as the APF's), spread-out and degenerate (three
distinct) ancestors, and the spread ones out of order; N for blocks of 8,
4, 2 and 1 warps on the stand-in card's 16 SMs. The warp dedup is also
held against #4's per-thread comparator
(``bipk_draw_update_packed_per_thread`` with the same ancestors;
``tests/test_torch_warp_rehearsal.py`` holds the warp #4 against it), and
the per-thread dedup against the plain version. The projection sets: m = 20 and 41 at n = 1 and 2, N
for blocks of 8, 4, 2 and 1 warps, a ragged N; the factor as views of an
augmented factor F (p, p, N), as the rank-1 cSMC reads it, and as
contiguous copies with NaN above chol's diagonal (which no kernel may
read); the per-thread outputs against the plain version.
"""

import ctypes

import pytest

from test_torch_warp_rehearsal import COMMON, HOST_SOURCES, _run, _specs, build_host_lib

# (m, n, N_in, N_out, lam, with prior, ancestors): blocks of 8 warps from
# 241 particles, 4 from 121, 2 from 61 (the wide blocks, slow on the
# stub, take two of the four kinds of ancestors each); one child process
# per set
DEDUP_SETS = {
    "8_and_4_warps": [
        (20, 1, 300, 257, 0.999, True, "resampled+out of order"),
        (20, 1, 150, 150, 1.0, False, "spread+degenerate"),
        (24, 2, 100, 130, 0.999, True, "resampled+spread"),
    ],
    "2_and_1_warps": [
        (20, 2, 100, 100, 1.0, True, "all"),
        (24, 2, 40, 40, 1.0, False, "all"),
        (9, 1, 40, 33, 0.999, True, "all"),
        (6, 2, 13, 20, 1.0, True, "all"),
    ],
}

# (m, n, N): two particles per warp at m = 20 (blocks of 8, 4, 1 warps),
# one at m = 41 (8, 4, 2)
PROJECT_SETS = {
    "m20": [(20, 1, 300), (20, 2, 150), (20, 1, 27)],
    "m41": [(41, 1, 130), (41, 2, 70), (41, 1, 33)],
}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The warp kernel and the per-thread comparators of the dedup gather,
    the projection and #4, built for the host once per module."""
    return build_host_lib(tmp_path_factory,
                          HOST_SOURCES + ("dedup_gather.cu", "unpacked_mniw.cu"))


DEDUP_CHILD = COMMON + r"""
from bipk_tpu_torch.ops import resampling

for spec in sys.argv[2:]:
    m, n, n_in, n_out, lam, with_prior, kinds = spec.split(",")
    m, n, n_in, n_out, lam = int(m), int(n), int(n_in), int(n_out), float(lam)
    with_prior = with_prior == "1"
    rng = np.random.default_rng(1000 * m + 10 * n + n_in + 11)
    S, prior, p3, scale = stats(rng, m, n, n_in)
    if not with_prior:
        prior, p3 = None, 0.0
    phi = torch.as_tensor(rng.standard_normal((m, n_out)) * scale, dtype=torch.float32)
    u = torch.as_tensor(rng.random((n, n_out)), dtype=torch.float32)
    v = torch.as_tensor(rng.random((n, n_out)), dtype=torch.float32)
    spread = np.sort(rng.integers(0, n_in, n_out))
    few = rng.integers(0, n_in, 3)
    # a resampler's ancestors on degenerate weights, as the APF's (a few
    # dominant particles); for N_out != N_in the first N_out of them
    w = torch.softmax(torch.as_tensor(8.0 * rng.standard_normal(n_in)), 0).float()
    resampled = resampling.systematic(w, float(rng.random()))
    ancestors = {
        "resampled": resampled[:n_out] if n_out <= n_in else torch.cat(
            [resampled, resampled[-1:].expand(n_out - n_in)]),
        "spread": torch.as_tensor(spread, dtype=torch.int32),
        "degenerate": torch.as_tensor(np.sort(few[rng.integers(0, 3, n_out)]),
                                      dtype=torch.int32),
        "out of order": torch.as_tensor(rng.permutation(spread), dtype=torch.int32),
    }
    label = f"m={m} n={n} N_in={n_in} N_out={n_out} lam={lam} prior={with_prior}"
    print(f"set {label} {kinds}", flush=True)
    for kind, anc in ancestors.items():
        if kinds != "all" and kind not in kinds.split("+"):
            continue
        anc = anc.contiguous()
        out = {k: ck._draw_update(k, S, anc, phi, u, v, jitter, lam, prior, p3, m, n,
                                  launch=getattr(lib, entry))[1]
               for k, entry in (("dedup", "bipk_draw_update_dedup_gather_packed"),
                                ("dedup_per_thread",
                                 "bipk_draw_update_dedup_gather_packed_per_thread"),
                                ("gather_per_thread", "bipk_draw_update_packed_per_thread"))}
        tag = f"dedup gather, {kind} ancestors, {label}"
        same(tag, DU, out["dedup"], out["dedup_per_thread"])
        same(f"{tag}, against the per-thread #4", DU, out["dedup"], out["gather_per_thread"])
        close(tag, DU, out["dedup_per_thread"], ck.draw_update_dedup_gather_packed_blocks_plain(
            S, anc, phi, u, v, jitter, lam, prior, p3, m, n), 1e-3)
print("dedup gather bitwise equal", flush=True)
"""

PROJECT_CHILD = COMMON + r"""
from bipk_tpu_torch.ops import cholup

for spec in sys.argv[2:]:
    m, n, N = (int(x) for x in spec.split(","))
    rng = np.random.default_rng(100 * m + 10 * n + N)
    S, prior, _, scale = stats(rng, m, n, N)
    phi = torch.as_tensor(rng.standard_normal((m, N)) * scale, dtype=torch.float32)
    # the factor of the prior plus the statistics, as the rank-1 cSMC
    # carries it: chol and white in an augmented factor F (m + n, m + n, N)
    flat = mniw.unpack_stats_bl(S, m, n)
    chol, white, _ = ck.factorize_blocks_plain(
        flat[0].reshape(m, n, N), flat[1].reshape(m, m, N), flat[2].reshape(n, n, N), jitter,
        1.0, prior)
    F = torch.full((m + n, m + n, N), float("nan"))
    F[:m, :m] = torch.tril(chol.permute(2, 0, 1)).permute(1, 2, 0)
    F[m:, :m] = white.transpose(0, 1)
    views = cholup.aug_to_factor(F, None, m)
    nan_above = torch.where(torch.tril(torch.ones(m, m, dtype=torch.bool))[..., None],
                            chol, torch.tensor(float("nan")))
    label = f"m={m} n={n} N={N}"
    print(f"set {label}", flush=True)
    want = ck.project_blocks_plain(chol, white, phi)
    for kind, (c, w_) in (("views of F", (views.chol, views.white_T0)),
                          ("contiguous, NaN above the diagonal",
                           (nan_above.contiguous(), white.contiguous()))):
        out = {k: ck._project(k, c, w_, phi, m, n, N, getattr(lib, entry))[1]
               for k, entry in (("warp", "bipk_project_blocks"),
                                ("per_thread", "bipk_project_blocks_per_thread"))}
        tag = f"projection from a given factor, {kind}, {label}"
        same(tag, ("mean", "col"), out["warp"], out["per_thread"])
        close(tag, ("mean", "col"), out["per_thread"], want, 1e-3)
print("projection bitwise equal", flush=True)
"""


@pytest.mark.parametrize("group", DEDUP_SETS)
def test_warp_dedup_equals_the_per_thread_kernels_bit_for_bit(host_lib, group):
    """The warp kDedup against ``dedup_gather_kernel`` and against #4's
    per-thread comparator on the same ancestors
    (``S_new``, ``y``, both log-determinants), with a resampler's, spread,
    degenerate and out-of-order ancestors; the per-thread dedup against
    the plain version at 1e-3 (``S_new`` 1e-4). One child per set."""
    for spec in _specs(DEDUP_SETS[group]):
        _run(DEDUP_CHILD, host_lib, [spec], "dedup gather bitwise equal")


@pytest.mark.parametrize("group", PROJECT_SETS)
def test_warp_projection_equals_the_per_thread_kernel_bit_for_bit(host_lib, group):
    """The warp kFromFactor against ``project_kernel<24 | 48>`` on views
    of an augmented factor and on contiguous copies with NaN above the
    diagonal (``mean``, ``col``); the per-thread outputs against the plain
    version at 1e-3. One child per set."""
    for spec in _specs(PROJECT_SETS[group]):
        _run(PROJECT_CHILD, host_lib, [spec], "projection bitwise equal")


def test_warp_dedup_and_projection_plans(host_lib):
    """``bipk_warp_mniw_plan`` for the two modes on the stand-in card (16
    SMs): the dedup gather plans as the draw, with the same floats (its
    stage lies in the particles' triangles) and 2P + 1 ints more, at every
    m <= 24 and n <= 2, and refuses m > 24; the projection from a given
    factor stages tril(chol), white and phi and keeps v, at every m <= 48,
    and refuses m > 48; the entries refuse what the plan refuses."""
    lib = ctypes.CDLL(str(host_lib))

    def plan(mode, m, n, N):
        out = [ctypes.c_int() for _ in range(3)]
        rc = lib.bipk_warp_mniw_plan(mode, m, n, N, *map(ctypes.byref, out))
        return rc, tuple(o.value for o in out)

    draw, dedup, from_factor = 1, 6, 7
    for m in range(1, 25):
        for n in (1, 2):
            for N in (20, 100, 300):
                rc, (W, P, smem) = plan(draw, m, n, N)
                assert rc == 0
                assert plan(dedup, m, n, N) == (0, (W, P, smem + 4 * (P + 1))), (m, n, N)
    for m, n, N, warps, per_warp in ((20, 1, 300, 8, 2), (20, 2, 150, 4, 2), (41, 1, 300, 8, 1),
                                     (41, 2, 70, 4, 1), (48, 2, 33, 2, 1), (9, 1, 20, 1, 2)):
        P = per_warp * warps
        lanes = 32 // per_warp
        ts = P | 1
        tile = (m * (m + 1) // 2 + m * n + m) * ts
        v = m | 1
        if lanes == 16:
            v += (48 - v % 32) % 32
        assert plan(from_factor, m, n, N) == (0, (warps, P, 4 * (tile + P * v) + 4 * P)), (m, n)
    assert plan(dedup, 25, 1, 300)[0] != 0 and plan(dedup, 24, 3, 300)[0] != 0
    assert plan(from_factor, 49, 1, 300)[0] != 0 and plan(from_factor, 20, 3, 300)[0] != 0
    f0, anc = ctypes.c_float(0.0), (ctypes.c_int * 8)()
    for m, n in ((25, 1), (24, 3), (0, 1)):
        assert lib.bipk_draw_update_dedup_gather_packed(
            None, 8, anc, 8, None, None, None, None, f0, m, n, f0, f0, None, None, None,
            None) != 0
    assert lib.bipk_project_blocks(
        None, ctypes.c_longlong(0), ctypes.c_longlong(0), None, ctypes.c_longlong(0),
        ctypes.c_longlong(0), None, 8, 49, 1, None, None, None) != 0
