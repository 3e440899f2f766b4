"""The systematic resampler's scan kernel (``systematic_scan_kernel``,
``csrc/systematic.cu``) against the per-thread kernel it replaced
(``systematic_kernel_per_thread``), bit for bit, and against the plain
version (``resampling.systematic``), run on the host.

``systematic.cu`` is compiled with ``g++`` against
``tests/cuda_threads_stub.h`` in place of ``<cuda_runtime.h>``, as
``tests/test_torch_warp_rehearsal.py`` does: every CUDA thread becomes a
host thread, a block's 1024 of them meet at ``__syncthreads`` / ``__syncwarp``
barriers, and the shuffles go through an exchange between two warp
barriers. The dynamic shared memory is the stub's NaN-filled block buffer;
the comparator's static ``__shared__`` arrays become ``static`` ones,
shared by the block's threads as the stub runs one block at a time. With
``-ffp-contract=off`` the scan kernel's ``__fmaf_rn(n, cdf, -u)`` and the
comparator's ``n * cdf - u`` both round the product and then the
difference, so equal bits say that both compute the same cdf in the same
order; that nvcc fuses the comparator's into one FFMA is read off its
machine code on the card, not here. The launches go through the wrappers'
own argument path (``cuda_kernels._systematic``) with the C entries
``bipk_systematic_ancestors`` and ``bipk_systematic_ancestors_per_thread``.
Both of the scan kernel's layouts are held: the resident one (rows and
rank array in shared memory), the entry's choice up to n = 32768 here,
and the streamed one (rows of 21 columns, the rank array in the output),
its choice above that, where the resident one must be refused; up to
32768 the streamed one is also named, at u = 0.5.

Sizes n in {1, 2, 7, 200, 1023, 1024, 1025, 4099, 32768} (resident) and
50,000 and 1,048,576 (streamed); weights
random, heavy-tailed (``softmax(8 randn)``), all mass on the first, the
last or a middle particle, zero mass, every 7th weight NaN, one +inf;
uniforms u in {0, 0.5, 0.999999}. Against the plain version with
``chip_smoke.check_systematic``'s tie tolerance (sorted, offspring counts
within 1, at most max(1, n // 50) slots moved), except where the plain
version has no answer to compare with: one +inf weight (its index
vector holds NaN, which ``index_add_`` refuses), and the uniform
fallback (zero or NaN mass) at u = 0 and 0.999999, where every grid
point ties a cdf value by construction, exactly or to within the f32
rounding of n cdf (1 - u = 1e-6 is below it), and both sides may round
each tie either way; at u = 0.5 the fallback must give 0, 1, ..., n-1.
At n = 1,048,576 the f32 cdf's rounding of n cdf reaches tens of slots
(10% of the slots move between any two f32 summation orders, the plain
version's included), so there only the offspring counts are held, within
1 of the plain version's in float64.
Each size is a child process with its own time limit, so that a barrier
that never opens fails the test instead of hanging it.
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

KINDS = ("random", "heavy", "first", "last", "middle", "zero", "nan7", "inf")
SIZES = [(n, KINDS) for n in (1, 2, 7, 200, 1023, 1024, 1025, 4099, 32768, 50000)]
SIZES.append((1_048_576, ("random", "middle")))

CHILD = r"""
import ctypes, sys
import numpy as np
import torch
from bipk_tpu_torch.ops import cuda_kernels as ck, resampling

torch.set_num_threads(1)
lib = ctypes.CDLL(sys.argv[1])
for name, argtypes in ck._SIGNATURES.items():
    if hasattr(lib, name):
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
ck._stream = lambda device: None


def weights(kind, n, rng):
    if kind == "random":
        return rng.random(n)
    if kind == "heavy":
        z = 8.0 * rng.standard_normal(n)
        e = np.exp(z - z.max())
        return e / e.sum()
    w = np.zeros(n)
    if kind in ("first", "last", "middle"):
        w[{"first": 0, "last": n - 1, "middle": n // 2}[kind]] = 1.0
    elif kind == "nan7":
        w = rng.random(n)
        w[::7] = np.nan
    elif kind == "inf":
        w = rng.random(n)
        w[n // 3] = np.inf
    return w


def tie_tolerance(label, got, w, ut, n):
    # chip_smoke.check_systematic's rule; at 2**20 particles the counts only
    if n < 2**20:
        want = resampling.systematic(w, ut)
        mism = int((got != want).sum())
    else:
        want = resampling.systematic(w.double(), ut.double())
        mism = 0
    diff = int((torch.bincount(got.long(), minlength=n)
                - torch.bincount(want.long(), minlength=n)).abs().max())
    assert diff <= 1 and mism <= max(1, n // 50), (
        f"{label}: {mism} slots differ from the plain version, offspring counts by {diff}")


n = int(sys.argv[2])
RESIDENT_UP_TO = 32768  # of the sizes here, the largest the resident layout fits
if n > RESIDENT_UP_TO:
    w, ut = torch.ones(n), torch.zeros(1)
    assert ck._systematic("resident", w, ut, n, lib.bipk_systematic_ancestors, 1)[0] != 0, (
        f"n={n}: the resident layout was not refused")
checked = 0
for kind in sys.argv[3].split(","):
    rng = np.random.default_rng(1000 * n + len(kind))
    w = torch.as_tensor(weights(kind, n, rng), dtype=torch.float32)
    for u in (0.0, 0.5, 0.999999):
        label = f"n={n} {kind} u={u}"
        ut = torch.tensor([u], dtype=torch.float32)
        rc_pt, want = ck._systematic("per-thread", w, ut, n,
                                     lib.bipk_systematic_ancestors_per_thread)
        assert rc_pt == 0, (label, rc_pt)
        for layout in (-1, 0) if n <= RESIDENT_UP_TO and u == 0.5 else (-1,):
            rc, got = ck._systematic("scan", w, ut, n, lib.bipk_systematic_ancestors, layout)
            assert rc == 0, (label, layout, rc)
            assert torch.equal(got, want), (
                f"{label} layout {layout}: the scan kernel differs from the per-thread one "
                f"in {int((got != want).sum())} of {n} slots, first at "
                f"{(got != want).nonzero()[:4].flatten().tolist()}")
        assert bool((got[1:] >= got[:-1]).all()) and 0 <= int(got.min()) <= int(got.max()) < n
        fallback = kind in ("zero", "nan7")
        if kind == "inf" or (fallback and u != 0.5):
            pass  # no plain answer to hold it to (the module's docstring)
        else:
            tie_tolerance(label, got, w, ut, n)
        if fallback and u == 0.5:
            assert torch.equal(got, torch.arange(n, dtype=torch.int32)), label
        checked += 1
print(f"bitwise equal on {checked} sets", flush=True)
"""


def _host_source(tmp_path):
    """``systematic.cu`` rewritten for the stub: each launch
    ``k<<<grid, threads, smem, stream>>>(args);`` becomes
    ``bipk_launch(grid, threads, smem, stream, [&] { k(args); });``, the
    dynamic shared memory the stub's block buffer and the static
    ``__shared__`` arrays ``static`` ones."""
    inc = tmp_path / "include"
    inc.mkdir()
    shutil.copy(STUB, inc / "cuda_runtime.h")
    launch = re.compile(r"([\w:]+(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\);", re.S)
    text = launch.sub(r"bipk_launch(\2, [&] { \1(\3); });", (CSRC / "systematic.cu").read_text())
    text = text.replace("extern __shared__ float smem[];", "float* smem = bipk_dynamic_smem();")
    text = text.replace("__shared__ ", "static ")
    assert "<<<" not in text and "__shared__" not in text
    (tmp_path / "systematic.cu").write_text(text)
    return inc, tmp_path / "systematic.cu"


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The resampler built for the host against the stub, once per module."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernels for the host")
    tmp_path = tmp_path_factory.mktemp("systematic_host")
    inc, src = _host_source(tmp_path)
    lib = tmp_path / "libbipk_systematic_host.so"
    build = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fno-strict-aliasing", "-fPIC",
         "-shared", "-pthread", "-I", str(inc), "-x", "c++", str(src), "-o", str(lib)],
        capture_output=True, text=True, timeout=TIMEOUT)
    assert build.returncode == 0, build.stderr[-4000:]
    return lib


@pytest.mark.parametrize("n,kinds", SIZES, ids=[f"n={n}" for n, _ in SIZES])
def test_scan_resampler_equals_the_per_thread_kernel_bit_for_bit(host_lib, n, kinds):
    run = subprocess.run([sys.executable, "-c", CHILD, str(host_lib), str(n), ",".join(kinds)],
                         cwd=REPO, capture_output=True, text=True, timeout=TIMEOUT)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-4000:]
    assert f"bitwise equal on {3 * len(kinds)} sets" in run.stdout
