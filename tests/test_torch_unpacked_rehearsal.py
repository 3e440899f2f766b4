"""The warp kernel's unpacked modes (``csrc/warp_mniw.cu``: kFactor, the
factorization written whole, kProjectUnpacked, the factorization
projected at phi, and kLogdetsUnpacked, the log-determinants at lam = 1
with no prior) against the per-thread kernels they replace
(``unpacked_mniw_kernel<24 | 48, kFactor | kProject | kLogdets>``,
``csrc/unpacked_mniw.cu``), bit for bit, run on the host.

The kernels are built with ``g++`` against ``tests/cuda_threads_stub.h``
as ``tests/test_torch_warp_rehearsal.py`` builds them (every CUDA thread a
host thread, ``-ffp-contract=off``: equal bits say that every output takes
the same operations in the same order), with ``unpacked_mniw.cu`` and
``dedup_gather.cu`` beside them. The launches go through the wrappers' own
argument paths (``cuda_kernels._factorize`` and
``cuda_kernels._factorize_project_unpacked``,
``cuda_kernels._logdets_unpacked``) with the C entries:
``bipk_factorize_blocks`` / ``bipk_factorize_project_blocks`` /
``bipk_log_base_measure_logdets`` (the warp kernel) and their
``*_per_thread`` comparators. The log-determinants take the statistics
plus the set's prior, packed (a filter's statistics alone may be
singular; the kernel itself takes no prior).

One child process per set, each with its own time limit: m = 20 at n = 1
and 2 (the vehicle's width), m = 24 with n = 2, m = 9, m = 6 with n = 2,
m = 41 at n = 1 and 2; N for blocks of 8, 4, 2 and 1 warps on the
stand-in card's 16 SMs (two particles per warp at m <= 24, one above),
most of them ragged; lambda = 0.999 with a prior and lambda = 1 without
one; structured and flat leaves (the projection takes both); and T1 and
T2 that are not exactly symmetric, which the kernels read as
0.5 (T1[i][c] + T1[c][i]) and as stored. The per-thread outputs are held
to the plain versions at 1e-3. On exactly symmetric statistics (the packed
``S`` unpacked) the sets also hold, bit for bit, the projection of
unpack(S) against the warp look-ahead (#1) on S, the factor's row against
#1's, (m <= 24) chol and white against the factor-emitting look-ahead's
``LW``, and the log-determinants of unpack(S + prior) against the warp
kLogdets (#5) on S + prior with no prior; chol is exactly zero above its
diagonal on every set.
"""

import ctypes

import pytest

from test_torch_warp_rehearsal import COMMON, HOST_SOURCES, _run, _specs, build_host_lib

# (m, n, N, lam, with prior, asymmetric T1 and T2)
UNPACKED_SETS = [
    (20, 1, 257, 0.999, True, False),  # 8 warps per block, ragged
    (20, 1, 150, 1.0, False, True),  # 4 warps
    (20, 2, 130, 1.0, False, False),  # 4 warps, ragged
    (24, 2, 64, 0.999, True, True),  # 2 warps
    (24, 2, 40, 0.999, True, False),  # 2 warps, ragged
    (9, 1, 33, 1.0, False, False),  # 1 warp, ragged
    (6, 2, 20, 0.999, True, True),  # 1 warp
    (41, 1, 130, 0.999, True, False),  # 8 warps (a warp per particle), ragged
    (41, 2, 40, 1.0, False, True),  # 2 warps, ragged
    (41, 2, 70, 0.999, True, False),  # 4 warps, ragged
]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The warp kernel and the per-thread comparators of the unpacked
    modes and of the look-ahead, built for the host once per module."""
    return build_host_lib(tmp_path_factory,
                          HOST_SOURCES + ("dedup_gather.cu", "unpacked_mniw.cu"))


UNPACKED_CHILD = COMMON + r"""
FACTOR = ("chol", "white", "row")
for spec in sys.argv[2:]:
    m, n, N, lam, with_prior, asym = spec.split(",")
    m, n, N, lam, with_prior, asym = int(m), int(n), int(N), float(lam), with_prior == "1", asym == "1"
    label = f"m={m} n={n} N={N} lam={lam} prior={with_prior} asymmetric={asym}"
    print(f"set {label}", flush=True)
    rng = np.random.default_rng(1000 * m + 10 * n + N + 13)
    S, prior, _, scale = stats(rng, m, n, N)
    if not with_prior:
        prior = None
    phi = torch.as_tensor(rng.standard_normal((m, N)) * scale, dtype=torch.float32)
    flat = [t.contiguous() for t in mniw.unpack_stats_bl(S, m, n)[:3]]
    if asym:
        # T1 and T2 off their symmetric parts by 1e-2 relative, entry by
        # entry (at n = 1 T2 is one entry: symmetric whatever its value)
        for i in (1, 2):
            flat[i] = (flat[i].double() * (1 + 1e-2 * rng.standard_normal(flat[i].shape))).float()
        T1 = flat[1].reshape(m, m, N)
        assert not torch.equal(T1, T1.transpose(0, 1))
    structured = (flat[0].reshape(m, n, N), flat[1].reshape(m, m, N), flat[2].reshape(n, n, N))

    fp = {}
    for layout, leaves, kw in (("structured", structured, {}), ("flat", tuple(flat), dict(m=m, n=n))):
        fp[layout] = {k: ck._factorize_project_unpacked(k, *leaves, phi, jitter, lam, prior, m, n,
                                                        getattr(lib, entry))[1]
                      for k, entry in (("warp", "bipk_factorize_project_blocks"),
                                       ("per_thread", "bipk_factorize_project_blocks_per_thread"))}
        tag = f"factorization/projection, {layout} leaves, {label}"
        same(tag, FP, fp[layout]["warp"], fp[layout]["per_thread"])
        close(tag, FP, fp[layout]["per_thread"],
              ck.factorize_project_blocks_plain(*leaves, phi, jitter, lam, prior, **kw), 1e-3)
    same(f"factorization/projection, flat against structured, {label}", FP,
         fp["flat"]["warp"], fp["structured"]["warp"])
    fb = {k: ck._factorize(k, *structured, jitter, lam, prior, m, n, getattr(lib, entry))[1]
          for k, entry in (("warp", "bipk_factorize_blocks"),
                           ("per_thread", "bipk_factorize_blocks_per_thread"))}
    tag = f"factorization, {label}"
    same(tag, FACTOR, fb["warp"], fb["per_thread"])
    close(tag, FACTOR, fb["per_thread"],
          ck.factorize_blocks_plain(*structured, jitter, lam, prior), 1e-3)
    above = torch.triu(torch.ones(m, m, dtype=torch.bool), 1)
    assert (fb["warp"][0][above].view(torch.int32) == 0).all(), f"{tag}: chol not +0 above the diagonal"
    if not asym:
        # the same statistics packed: the warp look-ahead (#1) and the
        # factor-emitting one (kEmit) on S
        packed = ck._factorize_project("fp", S, phi, jitter, lam, prior, m, n,
                                       launch=lib.bipk_factorize_project_packed)[1][:5]
        same(f"projection of unpack(S) against the warp #1 on S, {label}", FP,
             fp["structured"]["warp"], packed)
        same(f"factorization's row against #1's, {label}", ("row",), fb["warp"][2:], packed[2:3])
        if m <= mniw.FACTOR_MAX_M:
            LW = ck._factorize_project("emit", S, phi, jitter, lam, prior, m, n, True,
                                       launch=lib.bipk_factorize_project_packed)[1][5]
            same(f"factorization's chol and white against kEmit's LW, {label}",
                 ("chol", "white"), fb["warp"][:2], mniw.lw_to_factor(LW, m, n))
print("unpacked modes bitwise equal", flush=True)
"""


@pytest.mark.parametrize("spec", UNPACKED_SETS, ids=lambda s: "m{}n{}_N{}_lam{}_{}{}".format(
    *s[:4], "prior" if s[4] else "none", "_asym" if s[5] else ""))
def test_warp_unpacked_modes_equal_the_per_thread_kernels_bit_for_bit(host_lib, spec):
    """The warp kProjectUnpacked against ``unpacked_mniw_kernel<24 | 48,
    kProject>`` on structured and flat leaves (``mean``, ``col``, ``row``,
    both log-determinants) and the warp kFactor against ``<24 | 48,
    kFactor>`` (``chol``, ``white``, ``row``), with ``torch.equal``; the
    per-thread outputs against the plain versions at 1e-3; chol +0 above
    its diagonal; on symmetric statistics also the cross-layout
    equalities with the warp #1 and kEmit on the packed S."""
    _run(UNPACKED_CHILD, host_lib, _specs([spec]), "unpacked modes bitwise equal")


LOGDETS_CHILD = COMMON + r"""
for spec in sys.argv[2:]:
    m, n, N, lam, with_prior, asym = spec.split(",")
    m, n, N, asym = int(m), int(n), int(N), asym == "1"
    label = f"m={m} n={n} N={N} asymmetric={asym}"
    print(f"set {label}", flush=True)
    rng = np.random.default_rng(1000 * m + 10 * n + N + 17)
    S, prior, _, scale = stats(rng, m, n, N)
    # the statistics plus the prior, packed: a filter's statistics alone
    # may be singular, and the kernel itself takes no prior
    S_nat = S + mniw.pack_stats_bl(mniw.MNIW(*(b[..., None] for b in prior), torch.zeros(1)))
    flat = [t.contiguous() for t in mniw.unpack_stats_bl(S_nat, m, n)[:3]]
    if asym:
        for i in (1, 2):
            flat[i] = (flat[i].double() * (1 + 1e-2 * rng.standard_normal(flat[i].shape))).float()
        T1 = flat[1].reshape(m, m, N)
        assert not torch.equal(T1, T1.transpose(0, 1))
    structured = (flat[0].reshape(m, n, N), flat[1].reshape(m, m, N), flat[2].reshape(n, n, N))
    ld = {}
    for layout, leaves, kw in (("structured", structured, {}), ("flat", tuple(flat), dict(m=m, n=n))):
        ld[layout] = {k: ck._logdets_unpacked(k, *leaves, jitter, m, n, getattr(lib, entry))[1]
                      for k, entry in (("warp", "bipk_log_base_measure_logdets"),
                                       ("per_thread", "bipk_log_base_measure_logdets_per_thread"))}
        tag = f"log-determinants, {layout} leaves, {label}"
        same(tag, LD, ld[layout]["warp"], ld[layout]["per_thread"])
        close(tag, LD, ld[layout]["per_thread"],
              ck.log_base_measure_logdets_plain(*leaves, jitter, **kw), 1e-3)
    same(f"log-determinants, flat against structured, {label}", LD,
         ld["flat"]["warp"], ld["structured"]["warp"])
    if not asym:
        # the same statistics packed: the warp kLogdets (#5) on S + prior
        same(f"log-determinants of unpack(S + prior) against the warp #5 on S + prior, {label}",
             LD, ld["structured"]["warp"],
             logdets(S_nat, None, m, n, "bipk_log_base_measure_packed"))
print("unpacked log-determinants bitwise equal", flush=True)
"""


@pytest.mark.parametrize("spec", UNPACKED_SETS, ids=lambda s: "m{}n{}_N{}{}".format(
    *s[:3], "_asym" if s[5] else ""))
def test_warp_unpacked_log_determinants_equal_the_per_thread_kernel_bit_for_bit(host_lib, spec):
    """The warp kLogdetsUnpacked against ``unpacked_mniw_kernel<24 | 48,
    kLogdets>`` (both log-determinants) on the set's statistics plus its
    prior, structured and flat, with ``torch.equal``, in a child of its
    own; the per-thread outputs against the plain version at 1e-3; on
    symmetric statistics also against the warp kLogdets (#5) on the same
    statistics packed."""
    _run(LOGDETS_CHILD, host_lib, _specs([spec]), "unpacked log-determinants bitwise equal")


def test_warp_unpacked_plans(host_lib):
    """``bipk_warp_mniw_plan`` for the three unpacked modes on the
    stand-in card (16 SMs): kProjectUnpacked stages m n rows of T0,
    m(m+1)/2 of T1, n^2 of T2 (no T3 row) and m of phi, and keeps
    kProject's triangle (m + n + 1 rows) and m log-diagonal slots per
    particle; kFactor and kLogdetsUnpacked stage no phi and keep m + n
    rows; all at every m <= 48, n <= 2, and refused beyond, where the
    entries (and the log-determinants' per-thread comparator) refuse
    too."""
    lib = ctypes.CDLL(str(host_lib))

    def plan(mode, m, n, N):
        out = [ctypes.c_int() for _ in range(3)]
        rc = lib.bipk_warp_mniw_plan(mode, m, n, N, *map(ctypes.byref, out))
        return rc, tuple(o.value for o in out)

    factor, project_unpacked, logdets_unpacked = 4, 8, 9
    for m, n, N, warps, per_warp in ((20, 1, 257, 8, 2), (20, 2, 130, 4, 2), (24, 2, 64, 2, 2),
                                     (9, 1, 33, 1, 2), (41, 1, 130, 8, 1), (41, 2, 40, 2, 1),
                                     (48, 2, 70, 4, 1)):
        P = per_warp * warps
        rows = m * n + m * (m + 1) // 2 + n * n
        for mode, phi_rows in ((factor, 0), (project_unpacked, 1), (logdets_unpacked, 0)):
            tile = (rows + m * phi_rows) * (P | 1)
            floats = (m + n + phi_rows) * (m | 1) + m
            if per_warp == 2:
                floats += (48 - floats % 32) % 32
            assert plan(mode, m, n, N) == (0, (warps, P, 4 * (tile + P * floats) + 4 * P)), \
                (mode, m, n, N)
    for mode in (factor, project_unpacked, logdets_unpacked):
        assert plan(mode, 49, 1, 300)[0] != 0 and plan(mode, 20, 3, 300)[0] != 0
        assert plan(mode, 48, 2, 300)[0] == 0 and plan(mode, 1, 1, 300)[0] == 0
    f0 = ctypes.c_float(0.0)
    for m, n in ((49, 1), (20, 3), (0, 1)):
        assert lib.bipk_factorize_blocks(None, None, None, None, 8, m, n, f0, f0, None, None,
                                         None, None) != 0
        assert lib.bipk_factorize_project_blocks(None, None, None, None, None, 8, m, n, f0, f0,
                                                 None, None, None, None, None) != 0
        for entry in ("bipk_log_base_measure_logdets", "bipk_log_base_measure_logdets_per_thread"):
            assert getattr(lib, entry)(None, None, None, 8, m, n, f0, None, None) != 0
