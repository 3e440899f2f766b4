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
(``cuda_kernels._factorize_project`` / ``_draw_update``) with the two C
entries: ``bipk_factorize_project_packed`` / ``bipk_draw_update_packed``
(the warp kernels at every m) and their ``*_per_thread`` comparators.

The run is a child process with its own time limit, so that a barrier
that never opens (a lane that skips a shuffle) fails the test instead of
hanging it. Sets: m = 20 at n = 1 and 2 (the vehicle's width), m = 24,
m = 9, m = 6 with n = 2, and m = 41 (one and two rows per lane), a few
hundred particles or fewer, so that the stand-in card's 16 SMs give
blocks of 8, 4, 2 and 1 warps; ragged N_out != N_in; spread-out and
degenerate (three distinct) ancestors; lambda = 0.999 with a prior and
lambda = 1 without one.
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
TIMEOUT = 120  # seconds, for the build and for the run

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

CHILD = r"""
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


checked = 0
for spec in sys.argv[2:]:
    m, n, n_in, n_out, lam, with_prior = spec.split(",")
    m, n, n_in, n_out, lam, with_prior = int(m), int(n), int(n_in), int(n_out), float(lam), with_prior == "1"
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
    label = f"m={m} n={n} N_in={n_in} N_out={n_out} lam={lam} prior={with_prior}"

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


def _host_sources(tmp_path):
    """The CUDA sources rewritten for the stub: each launch
    ``k<<<grid, threads, smem, stream>>>(args);`` becomes
    ``bipk_launch(grid, threads, smem, stream, [&] { k(args); });`` and the
    dynamic shared-memory array the stub's block buffer."""
    inc = tmp_path / "include"
    inc.mkdir()
    shutil.copy(STUB, inc / "cuda_runtime.h")
    launch = re.compile(r"([\w:]+(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\);", re.S)
    out = []
    for path in [CSRC / "packed_mniw.cuh", CSRC / "packed_mniw.cu", CSRC / "warp_mniw.cu"]:
        text = launch.sub(r"bipk_launch(\2, [&] { \1(\3); });", path.read_text())
        text = text.replace("extern __shared__ float smem[];",
                            "float* smem = bipk_dynamic_smem();")
        assert "<<<" not in text and "__shared__" not in text, path.name
        (tmp_path / path.name).write_text(text)
        out.append(tmp_path / path.name)
    return inc, [p for p in out if p.suffix == ".cu"]


def test_warp_kernels_equal_the_per_thread_core_bit_for_bit(tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernels for the host")
    inc, srcs = _host_sources(tmp_path)
    lib = tmp_path / "libbipk_host.so"
    build = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-pthread",
         "-I", str(inc), "-x", "c++", *map(str, srcs), "-o", str(lib)],
        capture_output=True, text=True, timeout=TIMEOUT)
    assert build.returncode == 0, build.stderr[-4000:]
    specs = [",".join(str(int(x) if isinstance(x, bool) else x) for x in s) for s in SETS]
    run = subprocess.run([sys.executable, "-c", CHILD, str(lib), *specs], cwd=REPO,
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-4000:]
    assert f"bitwise equal on {len(SETS)} sets" in run.stdout
