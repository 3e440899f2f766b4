"""The warp-per-particle MNIW kernels (``csrc/warp_mniw.cu``) against the
per-thread core they replace (``packed_mniw_kernel<24 | 48, MODE>``,
``csrc/packed_mniw.cu``), bit for bit, run on the host.

``packed_mniw.cu`` and ``warp_mniw.cu`` are compiled with ``g++`` against
``tests/cuda_threads_stub.h`` in place of ``<cuda_runtime.h>``: every CUDA
thread becomes a host thread, ``__syncthreads`` / ``__syncwarp`` barriers
and the shuffles an exchange between two warp barriers (see the stub).
With ``-ffp-contract=off`` the per-thread core's ``a * b + c`` and the warp
kernels' ``__fmaf_rn`` both round the product and then the sum, so equal
bits say that every output takes the same operations in the same order;
which of them the card fuses is read off its machine code, not here. The
launches go through the wrappers' own argument paths
(``cuda_kernels._factorize_project`` / ``_draw_update`` / ``_logdets``)
with the C entries: ``bipk_factorize_project_packed`` /
``bipk_draw_update_packed`` / ``bipk_log_base_measure_packed`` (the warp
kernels at every m) and their ``*_per_thread`` comparators.

Each run is a child process with its own time limit, so that a barrier
that never opens (a lane that skips a shuffle) fails the test instead of
hanging it; a child prints each set before it starts it, and a child past
its limit fails with what it printed, so the failure names the set. Each
look-ahead and draw set has a child of its own (a parametrised case), and
so has each log-determinant set (run one after another).
The look-ahead and draw sets: m = 20 at n = 1 and 2 (the
vehicle's width), m = 24, m = 9, m = 6 with n = 2, and m = 41 (one and
two rows per lane), a few hundred particles or fewer, so that the
stand-in card's 16 SMs give blocks of 8, 4, 2 and 1 warps; ragged N_out
!= N_in; spread-out and degenerate (three distinct) ancestors; lambda =
0.999 with a prior and lambda = 1 without one. The log-determinant sets
(lambda = 1, as the cSMC calls them): the same widths with the prior, the
prior plus a reference-future offset, or none, on ragged N for every
block size. A third run holds the kernels' launch state per card on the
stub's two cards of 16 and 132 SMs.
"""

import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "bipk_tpu_torch" / "csrc"
STUB = Path(__file__).resolve().parent / "cuda_threads_stub.h"
TIMEOUT = 120  # seconds, for the build and for each run

# (m, n, N_in, N_out, lam, with prior)
SETS = [
    (20, 1, 300, 257, 0.999, True),
    (20, 2, 100, 100, 1.0, False),
    (24, 2, 40, 40, 0.999, True),
    (9, 1, 40, 33, 0.999, True),
    (6, 2, 13, 20, 1.0, True),
    (41, 1, 150, 150, 1.0, True),
    (41, 2, 40, 36, 0.999, True),
]

# the log-determinants: (m, n, N, prior: "future" = prior + a reference's
# future statistics, "prior", "none"); N chosen for blocks of 8, 4, 2 and
# 1 warps on the stand-in card's 16 SMs (two particles per warp at m <= 24)
LBM_SETS = [
    (20, 1, 257, "future"),
    (20, 1, 130, "none"),
    (20, 2, 100, "future"),
    (20, 2, 57, "none"),
    (24, 2, 40, "prior"),
    (9, 1, 33, "future"),
    (6, 2, 20, "prior"),
    (41, 1, 150, "future"),
    (41, 1, 70, "none"),
    (41, 2, 40, "future"),
    (41, 2, 20, "prior"),
]

COMMON = r"""
import ctypes, sys
import numpy as np
import torch
from bipk_tpu_torch.ops import cuda_kernels as ck, mniw

torch.set_num_threads(1)
lib = ctypes.CDLL(sys.argv[1])
for name, argtypes in ck._SIGNATURES.items():
    if hasattr(lib, name):
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
ck._stream = lambda device: None
jitter = mniw._default_jitter(torch.float32)
FP = ("mean", "col", "row", "logdet_T1", "logdet_Psi")
DU = ("S_new", "y", "logdet_T1", "logdet_Psi")
LD = ("logdet_T1", "logdet_Psi")


def stats(rng, m, n, N):
    # packed statistics of 60 forgotten rank-1 updates (f64, stored f32),
    # a proper MNIW prior, a basis vector per particle
    scale = np.linspace(0.2, 2.0, m)[:, None]
    S = 0.0
    for _ in range(60):
        phi = torch.as_tensor(rng.standard_normal((m, N)) * scale)
        y = torch.as_tensor(rng.standard_normal((n, N))) + 0.3 * phi[:n]
        S = 0.99 * S + mniw.pack_stats_bl(mniw.suff_stat_bl(y, phi))
    w = rng.standard_normal((m, m + 2))
    prior = mniw.natural_from_standard(
        rng.standard_normal((n, m)), w @ w.T / (m + 2) + 0.5 * np.eye(m), 1.7 * np.eye(n), 3.0)
    blocks = tuple(torch.as_tensor(np.asarray(p), dtype=torch.float32) for p in prior[:3])
    return S.float().contiguous(), blocks, float(np.asarray(prior[3])), scale


def same(label, names, warp, per_thread):
    for k, g, w in zip(names, warp, per_thread):
        assert torch.isfinite(w).all(), f"{label} {k}: the per-thread core gave non-finite values"
        assert torch.equal(g, w), (
            f"{label} {k}: the warp kernel differs from the per-thread core in "
            f"{int((g != w).sum())} of {g.numel()} entries, max "
            f"{(g.double() - w.double()).abs().max().item():.3e}")


def close(label, names, got, want, tol):
    # the per-thread core against the plain version: f32 summation orders
    # differ by ~kappa(A) eps_f32 relative (chip_smoke.py's tolerance)
    for k, g, w in zip(names, got, want):
        err = (g.double() - w.double()).abs().max() / w.double().abs().max().clamp(min=1e-30)
        assert err <= (1e-4 if k == "S_new" else tol), f"{label} {k}: {err:.3e} from the plain version"


def future(rng, m, n, scale):
    # a reference's future statistics: 30 rank-1 terms summed (f32), the
    # offset the cSMC adds to the prior
    phi = torch.as_tensor(rng.standard_normal((m, 30)) * scale)
    y = torch.as_tensor(rng.standard_normal((n, 30))) + 0.3 * phi[:n]
    return tuple(leaf.sum(-1).float() for leaf in mniw.suff_stat_bl(y, phi)[:3])


def logdets(S, prior, m, n, entry):
    return ck._logdets(entry, S, jitter, prior, m, n, getattr(lib, entry))[1]
"""

CHILD = COMMON + r"""
checked = 0
for spec in sys.argv[2:]:
    m, n, n_in, n_out, lam, with_prior = spec.split(",")
    m, n, n_in, n_out, lam, with_prior = int(m), int(n), int(n_in), int(n_out), float(lam), with_prior == "1"
    label = f"m={m} n={n} N_in={n_in} N_out={n_out} lam={lam} prior={with_prior}"
    print(f"set {label}", flush=True)
    rng = np.random.default_rng(1000 * m + 10 * n + n_in)
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

    fp = {k: ck._factorize_project(k, S, phi_in, jitter, lam, prior, m, n, launch=f)[1][:5]
          for k, f in (("warp", lib.bipk_factorize_project_packed),
                       ("per_thread", lib.bipk_factorize_project_packed_per_thread))}
    same(f"look-ahead {label}", FP, fp["warp"], fp["per_thread"])
    close(f"look-ahead {label}", FP, fp["per_thread"],
          ck.factorize_project_packed_plain(S, phi_in, jitter, lam, prior, m, n), 1e-3)
    draws = [(None, phi_in, rng.random((n, n_in)), rng.random((n, n_in))),
             (spread, phi, u, v), (degenerate, phi, u, v)]
    for anc, phi_d, u_d, v_d in draws:
        u_d, v_d = (torch.as_tensor(a, dtype=torch.float32) for a in (u_d, v_d))
        kind = "draw" if anc is None else ("gathered draw, " + ("spread" if anc is spread else "degenerate"))
        du = {k: ck._draw_update(k, S, anc, phi_d, u_d, v_d, jitter, lam, prior, p3, m, n,
                                 launch=f)[1]
              for k, f in (("warp", lib.bipk_draw_update_packed),
                           ("per_thread", lib.bipk_draw_update_packed_per_thread))}
        same(f"{kind} {label}", DU, du["warp"], du["per_thread"])
        S_src = S if anc is None else S.index_select(1, anc)
        close(f"{kind} {label}", DU, du["per_thread"], mniw.draw_update_packed_bl(
            u_d, v_d, S_src, phi_d,
            prior=None if prior is None else mniw.MNIW(*prior, torch.tensor(p3)),
            lam=lam, m=m, n=n, jitter=jitter), 1e-3)
    checked += 1
print(f"bitwise equal on {checked} sets", flush=True)
"""

LBM_CHILD = COMMON + r"""
checked = 0
for spec in sys.argv[2:]:
    m, n, N, kind = spec.split(",")
    m, n, N = int(m), int(n), int(N)
    rng = np.random.default_rng(1000 * m + 10 * n + N)
    S, prior, _, scale = stats(rng, m, n, N)
    if kind == "future":
        prior = tuple(p + f for p, f in zip(prior, future(rng, m, n, scale)))
    elif kind == "none":
        prior = None
    label = f"log-determinants m={m} n={n} N={N} prior={kind}"
    print(f"set {label}", flush=True)
    warp = logdets(S, prior, m, n, "bipk_log_base_measure_packed")
    per_thread = logdets(S, prior, m, n, "bipk_log_base_measure_packed_per_thread")
    same(label, LD, warp, per_thread)
    close(label, LD, per_thread, ck.log_base_measure_packed_logdets_plain(S, jitter, prior, m, n),
          1e-3)
    checked += 1
print(f"bitwise equal on {checked} sets", flush=True)
"""

DEVICE_CHILD = COMMON + r"""
lib.bipk_stub_set_device.argtypes = [ctypes.c_int]
lib.bipk_stub_attribute_calls.argtypes = [ctypes.c_int, ctypes.c_void_p]


def plan(mode, m, n, N):
    out = [ctypes.c_int() for _ in range(3)]
    assert lib.bipk_warp_mniw_plan(mode, m, n, N, *map(ctypes.byref, out)) == 0
    return tuple(o.value for o in out)


def attribute_calls(dev):
    kernels = ctypes.c_int()
    calls = lib.bipk_stub_attribute_calls(dev, ctypes.byref(kernels))
    return calls, kernels.value


rng = np.random.default_rng(7)
data = {m: stats(rng, m, 1, 100) for m in (20, 41)}


def launches():
    # three instantiations: the look-ahead at m = 41 (a warp per particle)
    # and the log-determinants at m = 41 and m = 20 (two per warp), each
    # twice; the log-determinants held against the per-thread core
    for m, (S, prior, _, scale) in data.items():
        phi = torch.as_tensor(rng.standard_normal((m, 100)) * scale, dtype=torch.float32)
        for _ in range(2):
            if m == 41:
                ck._factorize_project("fp", S, phi, jitter, 1.0, prior, m, 1,
                                      launch=lib.bipk_factorize_project_packed)
            same(f"log-determinants m={m} N=100",
                 LD, logdets(S, prior, m, 1, "bipk_log_base_measure_packed"),
                 logdets(S, prior, m, 1, "bipk_log_base_measure_packed_per_thread"))


# card 0 (16 SMs): N = 200 at m = 41 would fill its SMs with 8-warp blocks
lib.bipk_stub_set_device(0)
launches()
assert attribute_calls(0) == (3, 3), attribute_calls(0)
assert attribute_calls(1) == (0, 0), attribute_calls(1)
assert plan(0, 41, 1, 200)[0] == 8, plan(0, 41, 1, 200)
# card 1 (132 SMs), after launches on card 0: one-warp blocks, planned
# by card 1's own SM count, and the limit raised there once per kernel
lib.bipk_stub_set_device(1)
assert plan(0, 41, 1, 200)[:2] == (1, 1), plan(0, 41, 1, 200)
assert plan(2, 20, 1, 200)[:2] == (1, 2), plan(2, 20, 1, 200)
launches()
assert attribute_calls(1) == (3, 3), attribute_calls(1)
assert attribute_calls(0) == (3, 3), attribute_calls(0)
lib.bipk_stub_set_device(0)
assert plan(0, 41, 1, 200)[0] == 8, plan(0, 41, 1, 200)
print("launch state kept per card", flush=True)
"""


# the sources the warp kernels' rehearsals build: the per-thread core and
# its entries, the warp kernel
HOST_SOURCES = ("packed_mniw.cuh", "packed_mniw.cu", "warp_mniw.cu")


def _host_sources(tmp_path, names=HOST_SOURCES):
    """The CUDA sources ``names`` rewritten for the stub: each launch
    ``k<<<grid, threads, smem, stream>>>(args);`` becomes
    ``bipk_launch(grid, threads, smem, stream, [&] { k(args); });``, the
    dynamic shared-memory array the stub's block buffer and a static
    ``__shared__`` array a ``static`` one (the stub runs one block at a
    time); plus one translation unit with the stub's controls."""
    inc = tmp_path / "include"
    inc.mkdir()
    shutil.copy(STUB, inc / "cuda_runtime.h")
    launch = re.compile(r"([\w:]+(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\);", re.S)
    out = []
    for path in (CSRC / name for name in names):
        text = launch.sub(r"bipk_launch(\2, [&] { \1(\3); });", path.read_text())
        text = text.replace("extern __shared__ float smem[];",
                            "float* smem = bipk_dynamic_smem();")
        text = text.replace("__shared__ ", "static ")
        assert "<<<" not in text and "__shared__" not in text, path.name
        (tmp_path / path.name).write_text(text)
        out.append(tmp_path / path.name)
    controls = tmp_path / "stub_controls.cu"
    controls.write_text('#define BIPK_STUB_CONTROLS\n#include "cuda_runtime.h"\n')
    return inc, [p for p in out if p.suffix == ".cu"] + [controls]


def build_host_lib(tmp_path_factory, names=HOST_SOURCES):
    """The sources ``names`` built for the host against the stub; skips
    without ``g++``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernels for the host")
    tmp_path = tmp_path_factory.mktemp("warp_host")
    inc, srcs = _host_sources(tmp_path, names)
    lib = tmp_path / "libbipk_host.so"
    build = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-pthread",
         "-I", str(inc), "-x", "c++", *map(str, srcs), "-o", str(lib)],
        capture_output=True, text=True, timeout=TIMEOUT)
    assert build.returncode == 0, build.stderr[-4000:]
    return lib


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The kernels built for the host against the stub, once per module."""
    return build_host_lib(tmp_path_factory)


def _run(code, lib, specs, expect):
    """Run ``code`` in a child process on the host library ``lib`` with
    the set specs as arguments; it must exit 0 within ``TIMEOUT`` and print
    ``expect``. A child past its limit fails the test with what it printed
    (the set it was on)."""
    try:
        run = subprocess.run([sys.executable, "-c", code, str(lib), *specs], cwd=REPO,
                             capture_output=True, text=True, timeout=TIMEOUT)
    except subprocess.TimeoutExpired as e:
        said = e.stdout.decode() if isinstance(e.stdout, bytes) else (e.stdout or "")
        pytest.fail(f"child past its {TIMEOUT} s limit on {specs}; it printed:\n{said[-2000:]}")
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-4000:]
    assert expect in run.stdout, run.stdout[-2000:]


def _specs(sets):
    return [",".join(str(int(x) if isinstance(x, bool) else x) for x in s) for s in sets]


@pytest.mark.parametrize("spec", SETS, ids=lambda s: "m{}n{}_{}to{}_lam{}_{}".format(
    *s[:5], "prior" if s[5] else "none"))
def test_warp_kernels_equal_the_per_thread_core_bit_for_bit(host_lib, spec):
    """The warp look-ahead, draw and gathered draw (spread and degenerate
    ancestors) against the per-thread core bit for bit on one set, in a
    child of its own; the per-thread outputs against the plain versions at
    1e-3 (``S_new`` 1e-4)."""
    _run(CHILD, host_lib, _specs([spec]), "bitwise equal on 1 sets")


def test_warp_log_determinants_equal_the_per_thread_core_bit_for_bit(host_lib):
    """``bipk_log_base_measure_packed`` (the warp kernel's kLogdets mode)
    against ``bipk_log_base_measure_packed_per_thread`` bit for bit, and the
    per-thread core against the plain version at 1e-3; one child per set."""
    for spec in _specs(LBM_SETS):
        _run(LBM_CHILD, host_lib, [spec], "bitwise equal on 1 sets")


def test_warp_launch_state_is_kept_per_card(host_lib):
    """On the stub's two cards (16 and 132 SMs): the launch plan on card 1
    after launches on card 0 follows card 1's SM count, and the dynamic
    shared-memory limit is raised once per kernel instantiation on each
    card, on that card."""
    _run(DEVICE_CHILD, host_lib, [], "launch state kept per card")
