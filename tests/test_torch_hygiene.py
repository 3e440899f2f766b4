"""Guards of the PyTorch port: what it imports, where it runs, how it is
built and packaged."""

import ast
import subprocess
import sys
import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch
from setuptools import find_packages

from bipk_tpu_torch import resolve_device
from bipk_tpu_torch.models import oscillator as tosc
from bipk_tpu_torch.models import toy as ttoy
from bipk_tpu_torch.models import vehicle as tveh
from bipk_tpu_torch.ops import _build
from bipk_tpu_torch.ops import cuda_kernels as ck
from bipk_tpu_torch.algorithms.apf import build_apf
from bipk_tpu_torch.algorithms.csmc import build_csmc
from bipk_tpu_torch.algorithms.gibbs import build_gibbs
from bipk_tpu_torch.parallel.sharded import build_sharded_apf
from bipk_tpu_torch.parallel.sharded_csmc import build_sharded_csmc

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "bipk_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py",
                                                              REPO / "chip_compare.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "bipk_tpu"), (path, mod)


def test_port_imports_with_jax_absent():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['bipk_tpu'] = None\n"
        "import bipk_tpu_torch, bipk_tpu_torch.convert\n"
        "import bipk_tpu_torch.parallel.sharded, bipk_tpu_torch.ops.cuda_kernels\n"
        "import bipk_tpu_torch.parallel.mesh, bipk_tpu_torch.parallel.distributed\n"
        "import bipk_tpu_torch.parallel.global_resampling, bipk_tpu_torch.parallel.sharded_csmc\n"
        "import bipk_tpu_torch.algorithms.gibbs, bipk_tpu_torch.utils.matio\n"
        "import bipk_tpu_torch.models.oscillator, bipk_tpu_torch.models.toy\n"
        "import bipk_tpu_torch.ops.cholup, bipk_tpu_torch.algorithms.csmc\n"
        "import bipk_tpu_torch.utils.diagnostics, bipk_tpu_torch.utils.checkpoint\n"
        "import bipk_tpu_torch.utils.profiling, bipk_tpu_torch.utils.plotting\n"
        "import bipk_tpu_torch.scripts.toy_example, bipk_tpu_torch.scripts.vehicle\n"
        "import bipk_tpu_torch.scripts.single_mass_oscillator, bipk_tpu_torch.scripts.emps\n"
        "assert 'matplotlib' not in sys.modules, 'matplotlib imported at import time'\n"
        "print('ok')"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_cuda_entry_point_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    cfg = tveh.VehicleConfig(t_end=0.1)
    model = tveh.make_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_sharded_apf(model.ssm, model.gps, 64)  # default device: cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        tveh.simulate(torch.Generator().manual_seed(0), cfg)


def test_gibbs_slice_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = tveh.make_model(tveh.VehicleConfig(t_end=0.1))
    for build in (lambda: build_apf(model.ssm, model.gps, 64),
                  lambda: build_csmc(model.ssm, model.gps, 64),
                  lambda: build_gibbs(model.ssm, model.gps, 64, 3),
                  lambda: build_sharded_csmc(model.ssm, model.gps, 64)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()  # default device: cuda


def test_cs_models_run_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tosc.simulate(g, tosc.OscillatorConfig(t_end=0.1))  # default device: cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        ttoy.simulate(g, ttoy.ToyConfig(n_steps=5))
    model = ttoy.make_model(ttoy.ToyConfig(n_steps=5))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_gibbs(model.ssm, model.gps, 64, 3)


@pytest.mark.parametrize("name", ["toy_example", "single_mass_oscillator", "vehicle", "emps"])
def test_entry_scripts_run_on_the_card_unless_asked(monkeypatch, tmp_path, name):
    """Without ``--cpu`` every entry script asks for CUDA and raises when
    there is no card, before it writes anything."""
    import importlib

    script = importlib.import_module(f"bipk_tpu_torch.scripts.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--out", str(tmp_path / "out.mat")] + (["--no-plot"] if name == "toy_example" else [])
    with pytest.raises(RuntimeError, match="CUDA"):
        script.run(script.parse_args(argv))
    assert not any(tmp_path.iterdir())


def test_launches_count_per_instantiation():
    """The packed-MNIW wrappers count each launch once in total and once
    for the kernel that serves its m: the warp kernels for the look-ahead,
    both draws and the log-determinants, ``<24w>`` for m <= 24 and
    ``<48w>`` for 24 < m <= 48, and for the factor pair (m <= 24): the
    factor-emitting projection ``[emit]<24w>``, the factor-gather draw
    ``<24w>``, and the dedup gather (m <= 24) ``<24w>``; the per-thread
    comparator ``<24>`` / ``<48>`` / ``[emit]<24>``."""
    warp = (ck.factorize_project_packed, ck.draw_update_packed_blocks,
            ck.draw_update_gather_packed_blocks, ck.log_base_measure_packed_logdets)
    assert ck.WARP == (*warp, ck.draw_update_factor_gather_packed_blocks,
                       ck.draw_update_dedup_gather_packed_blocks, ck.project_blocks,
                       ck.factorize_blocks, ck.factorize_project_blocks,
                       ck.log_base_measure_logdets)
    ck.reset_launch_counts()
    try:
        for fn in warp:
            for m in (20, 24, 25, 41, 48):
                ck._count(fn, m)
        ck._count(ck.systematic_ancestors_blocks)
        ck._count(ck.factorize_project_packed, 20, "[emit]")
        ck._count(ck.factorize_project_packed, 24, "[emit]", per_thread=True)
        ck._count(ck.draw_update_factor_gather_packed_blocks, 20)
        ck._count(ck.draw_update_factor_gather_packed_blocks, 24, per_thread=True)
        ck._count(ck.draw_update_gather_packed_blocks, 41, per_thread=True)
        ck._count(ck.factorize_project_packed, 20, per_thread=True)
        ck._count(ck.log_base_measure_packed_logdets, 41, per_thread=True)
        ck._count(ck.draw_update_dedup_gather_packed_blocks, 20)
        ck._count(ck.draw_update_dedup_gather_packed_blocks, 9, per_thread=True)
        counts = ck.launch_counts()
        for fn in warp:
            assert counts[f"{fn.__name__}<24w>"] == 2
            assert counts[f"{fn.__name__}<48w>"] == 3
        assert counts["factorize_project_packed<24>"] == 1
        assert counts["factorize_project_packed<48>"] == 0
        assert counts["draw_update_packed_blocks<24>"] == 0
        assert counts["draw_update_packed_blocks<48>"] == 0
        assert counts["draw_update_gather_packed_blocks<24>"] == 0
        assert counts["draw_update_gather_packed_blocks<48>"] == 1
        assert counts["log_base_measure_packed_logdets<24>"] == 0
        assert counts["log_base_measure_packed_logdets<48>"] == 1
        assert counts["factorize_project_packed[emit]<24w>"] == 1
        assert counts["factorize_project_packed[emit]<24>"] == 1
        assert counts["draw_update_factor_gather_packed_blocks<24w>"] == 1
        assert counts["draw_update_factor_gather_packed_blocks<24>"] == 1
        assert counts["draw_update_dedup_gather_packed_blocks<24w>"] == 1
        assert counts["draw_update_dedup_gather_packed_blocks<24>"] == 1
        assert counts["systematic_ancestors_blocks"] == 1
        assert ck.factorize_project_packed.launches == 8
        assert ck.draw_update_factor_gather_packed_blocks.launches == 2
        assert ck.draw_update_dedup_gather_packed_blocks.launches == 2
        assert ck.draw_update_gather_packed_blocks.launches == 6
        assert ck.log_base_measure_packed_logdets.launches == 6
        assert sum(counts.values()) == 30
    finally:
        ck.reset_launch_counts()
    # the CPU computes the plain version and counts no launch
    S = torch.eye(ck.mniw.packed_rows(41, 1), 4)
    ck.log_base_measure_packed_logdets(S, 1e-9, m=41, n=1)
    assert sum(ck.launch_counts().values()) == 0


def test_gibbs_slice_unported_modes_raise():
    """``n_chains=4`` builds the chain-parallel sampler; ``mesh=`` and
    ``shard_mesh=`` build the particle-sharded cSMC; the chain mesh still
    raises, ``NotImplementedError`` naming Queue A item 2, and the
    combinations the JAX package refuses raise ``ValueError``."""
    from bipk_tpu_torch.algorithms.gibbs import Gibbs, ParallelGibbs
    from bipk_tpu_torch.parallel.mesh import ParticleMesh
    from bipk_tpu_torch.parallel.sharded_csmc import ShardedCSMC

    model = tveh.make_model(tveh.VehicleConfig(t_end=0.1))
    one = ParticleMesh(None, 0, 1, torch.device("cpu"))
    assert isinstance(build_csmc(model.ssm, model.gps, 64, mesh=one), ShardedCSMC)
    chains = build_gibbs(model.ssm, model.gps, 64, 3, device="cpu", n_chains=4)
    assert isinstance(chains, ParallelGibbs) and chains.n_chains == 4
    for kwargs in (dict(mesh=one), dict(shard_mesh=one)):
        gibbs = build_gibbs(model.ssm, model.gps, 64, 3, **kwargs)
        assert isinstance(gibbs, Gibbs) and isinstance(gibbs.csmc, ShardedCSMC)
    with pytest.raises(NotImplementedError, match="Queue A item 2"):
        build_gibbs(model.ssm, model.gps, 64, 3, device="cpu", n_chains=4,
                    chain_mesh=object())
    for kwargs in (dict(chain_mesh=object()), dict(n_chains=4, mesh=one),
                   dict(n_chains=4, shard_mesh=one), dict(n_chains=1),
                   dict(mesh=one, shard_mesh=one)):
        with pytest.raises(ValueError):
            build_gibbs(model.ssm, model.gps, 64, 3, device="cpu", **kwargs)
    with pytest.raises(ValueError, match="single-device"):
        build_csmc(model.ssm, model.gps, 64, mesh=one, rank1=True)
    assert sum(ck.launch_counts().values()) == 0


def test_rank1_csmc_is_a_build_csmc_option_only():
    """``rank1=True`` builds the factor-carry sweep; with the packed
    kernels' opt-ins it raises (it never launches them); ``build_gibbs``
    has no ``rank1`` keyword, as the JAX package's has none; on the
    default device it needs a card."""
    from bipk_tpu_torch.algorithms.csmc import CSMCRank1

    model = tveh.make_model(tveh.VehicleConfig(t_end=0.1))
    assert isinstance(build_csmc(model.ssm, model.gps, 64, device="cpu", rank1=True), CSMCRank1)
    for option in ("reuse_factor", "dedup_gather"):
        with pytest.raises(ValueError, match="rank1"):
            build_csmc(model.ssm, model.gps, 64, device="cpu", rank1=True, **{option: True})
    with pytest.raises(TypeError, match="rank1"):
        build_gibbs(model.ssm, model.gps, 64, 3, device="cpu", rank1=True)


def test_rank1_csmc_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = tveh.make_model(tveh.VehicleConfig(t_end=0.1))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_csmc(model.ssm, model.gps, 64, rank1=True)  # default device: cuda


def test_pgas_and_emps_entry_points_raise_without_a_card(monkeypatch):
    """Classic PGAS and the EMPS entry point resolve to CUDA and raise
    without a card (no fallback to the CPU); the EMPS modules import with
    JAX absent."""
    from bipk_tpu_torch.algorithms import build_pgas, build_pgas_csmc
    from bipk_tpu_torch.scripts import emps as emps_script

    code = ("import sys; sys.modules['jax'] = None; sys.modules['bipk_tpu'] = None\n"
            "import bipk_tpu_torch.algorithms.pgas, bipk_tpu_torch.models.emps\n"
            "import bipk_tpu_torch.scripts.emps, bipk_tpu_torch.utils.matio\n"
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fns = (lambda x, u: x, lambda obs, x, u: -x[0] ** 2)
    prior = ck.mniw.natural_from_standard(np.zeros((1, 1)), np.eye(1), np.eye(1), 3.0)
    for build in (lambda: build_pgas_csmc(*fns, 64),
                  lambda: build_pgas(*fns, prior, 64, 3)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()  # default device: cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        emps_script.main(["--quick"])


class _CardTensor:
    """Stands in for a CUDA tensor, which this CPU build of torch cannot
    make: the unpacked entry points read only a leaf's device, dtype and
    shape before they decide between the kernel and the plain version."""

    device = torch.device("cuda")

    def __init__(self, *shape, dtype=torch.float32):
        self.shape, self.dtype = shape, dtype

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return 0

    def reshape(self, *shape):
        return _CardTensor(*shape, dtype=self.dtype)

    def stride(self, dim=None):
        strides = [1] * len(self.shape)
        for d in range(len(self.shape) - 2, -1, -1):
            strides[d] = strides[d + 1] * self.shape[d + 1]
        return tuple(strides) if dim is None else strides[dim]


def _entry_point_call(name, m, n, dtype):
    from bipk_tpu_torch.ops import mniw

    N = 8
    leaf = lambda *shape: _CardTensor(*shape, N, dtype=dtype)
    stats = mniw.MNIW(leaf(m, n), leaf(m, m), leaf(n, n), leaf())
    factor = mniw.MNIWFactor(leaf(m, m), leaf(m, n), leaf(n, n), leaf())
    calls = {
        "factorize_bl": lambda: mniw.factorize_bl(stats),
        "factorize_scaled_bl": lambda: mniw.factorize_scaled_bl(stats, lam=0.999),
        "factorize_project_bl": lambda: mniw.factorize_project_bl(stats, leaf(m)),
        "log_base_measure_bl": lambda: mniw.log_base_measure_bl(stats),
        "factor_mean_at_bl": lambda: mniw.factor_mean_at_bl(factor, leaf(m)),
        "sample_predictive_bl": lambda: mniw.sample_predictive_bl(
            factor, leaf(m), leaf(n), leaf(n)),
    }
    return calls[name]()


@pytest.mark.parametrize("name", ["factorize_bl", "factorize_scaled_bl", "factorize_project_bl",
                                  "log_base_measure_bl", "factor_mean_at_bl",
                                  "sample_predictive_bl"])
def test_unpacked_entry_points_raise_on_card_tensors_the_kernels_cannot_take(name):
    """On a CUDA tensor the kernels cannot take (not float32, m > 48,
    n > 2) an unpacked entry point raises, as the packed wrappers do,
    naming itself; it never computes the plain version on the card."""
    with pytest.raises(TypeError, match=f"{name}: .*float64"):
        _entry_point_call(name, 20, 1, torch.float64)
    with pytest.raises(ValueError, match=f"{name}: .*m <= 48.*m=49"):
        _entry_point_call(name, 49, 1, torch.float32)
    with pytest.raises(ValueError, match=f"{name}: .*n <= 2.*n=3"):
        _entry_point_call(name, 20, 3, torch.float32)


class _RecordingLib:
    """Stands in for the kernel library: records the C entry each launch
    reaches and returns success."""

    def __init__(self):
        self.called = []

    def __getattr__(self, name):
        if not name.startswith("bipk_"):
            raise AttributeError(name)
        return lambda *args: self.called.append(name) or 0


def _packed_wrapper_calls(m, n=1, N=8):
    """Every packed-MNIW wrapper that takes width m, on stand-ins for CUDA
    tensors."""
    rows = ck.mniw.packed_rows(m, n)
    S, phi, u = _CardTensor(rows, N), _CardTensor(m, N), _CardTensor(n, N)
    anc = _CardTensor(N, dtype=torch.int32)
    calls = {
        "factorize_project_packed": lambda: ck.factorize_project_packed(S, phi, 0.0, m=m, n=n),
        "draw_update_packed_blocks": lambda: ck.draw_update_packed_blocks(
            S, phi, u, u, 0.0, m=m, n=n),
        "draw_update_gather_packed_blocks": lambda: ck.draw_update_gather_packed_blocks(
            S, anc, phi, u, u, 0.0, m=m, n=n),
        "log_base_measure_packed_logdets": lambda: ck.log_base_measure_packed_logdets(
            S, 0.0, m=m, n=n),
    }
    if m <= ck.mniw.FACTOR_MAX_M:
        LW = _CardTensor(ck.mniw.lw_rows(m, n), N)
        calls["factorize_project_packed[emit]"] = lambda: ck.factorize_project_packed(
            S, phi, 0.0, m=m, n=n, emit_factor=True)
        calls["draw_update_factor_gather_packed_blocks"] = (
            lambda: ck.draw_update_factor_gather_packed_blocks(S, LW, anc, phi, u, u, 0.0,
                                                               m=m, n=n))
        calls["draw_update_dedup_gather_packed_blocks"] = (
            lambda: ck.draw_update_dedup_gather_packed_blocks(S, anc, phi, u, u, 0.0, m=m, n=n))
    chol, white = _CardTensor(m, m, N), _CardTensor(m, n, N)
    calls["project_blocks"] = lambda: ck.project_blocks(chol, white, phi)
    leaves = (_CardTensor(m, n, N), _CardTensor(m, m, N), _CardTensor(n, n, N))
    calls["factorize_blocks"] = lambda: ck.factorize_blocks(*leaves, 0.0)
    calls["factorize_project_blocks"] = lambda: ck.factorize_project_blocks(*leaves, phi, 0.0)
    calls["log_base_measure_logdets"] = lambda: ck.log_base_measure_logdets(*leaves, 0.0)
    return calls


def _recording_lib(monkeypatch):
    """The recording stand-in library in place of the kernels', with the
    stream and the outputs' allocation made to work on the CPU."""
    lib = _RecordingLib()
    empty = torch.empty
    monkeypatch.setattr(ck, "_lib", lambda: lib)
    monkeypatch.setattr(ck, "_stream", lambda device: 0)
    monkeypatch.setattr(torch, "empty", lambda shape, dtype=None, device=None: empty(shape, dtype=dtype))
    return lib


@pytest.mark.parametrize("m", [20, 25, 41, 48])
def test_per_thread_comparator_is_reachable_from_no_wrapper(monkeypatch, m):
    """On a CUDA tensor every packed wrapper, the projection from a given
    factor and the unpacked factorization, factorization/projection and
    log-determinants reach their own C entries, which launch the warp
    kernels for the look-ahead, the draws, the log-determinants, the
    projection and the unpacked modes at every m (counted ``<24w>`` for m <= 24, ``<48w>``
    above) and for the
    factor pair and the dedup gather at m <= 24 (``[emit]<24w>``,
    ``<24w>``); none reaches the per-thread comparator's entries, and none
    falls back to the plain version (a stand-in tensor has no data to
    compute on)."""
    lib = _recording_lib(monkeypatch)
    ck.reset_launch_counts()
    try:
        calls = _packed_wrapper_calls(m)
        for call in calls.values():
            call()
        counts = ck.launch_counts()
    finally:
        ck.reset_launch_counts()
    assert len(lib.called) == len(calls)
    assert not [c for c in lib.called if "per_thread" in c]
    width = "<24" if m <= 24 else "<48"
    for fn in (*ck.WARP[:4], ck.project_blocks, ck.factorize_blocks, ck.factorize_project_blocks,
               ck.log_base_measure_logdets):
        assert counts[f"{fn.__name__}{width}w>"] == 1
        assert counts[f"{fn.__name__}<24>"] == 0
        assert counts[f"{fn.__name__}<48>"] == 0
    assert "bipk_log_base_measure_packed" in lib.called
    assert "bipk_log_base_measure_logdets" in lib.called
    assert "bipk_project_blocks" in lib.called
    assert "bipk_factorize_blocks" in lib.called
    assert "bipk_factorize_project_blocks" in lib.called
    if m <= 24:
        assert counts["factorize_project_packed[emit]<24w>"] == 1
        assert counts["factorize_project_packed[emit]<24>"] == 0
        for fn in (ck.draw_update_factor_gather_packed_blocks,
                   ck.draw_update_dedup_gather_packed_blocks):
            assert counts[f"{fn.__name__}<24w>"] == 1
            assert counts[f"{fn.__name__}<24>"] == 0
        assert "bipk_draw_update_factor_gather_packed" in lib.called
        assert "bipk_draw_update_dedup_gather_packed" in lib.called
    assert sum(counts.values()) == len(calls)


@pytest.mark.parametrize("m", [20, 41])
def test_per_thread_comparator_counts_its_width_and_reaches_its_entry(monkeypatch, m):
    """The comparator, given (stand-ins for) CUDA tensors, reaches the
    ``*_per_thread`` C entries and counts the per-thread instantiation
    that serves m: ``<24>`` for m <= 24, ``<48>`` above; no warp key. So
    do the projection's (``project_kernel<24 | 48>``), the unpacked
    factorization's, factorization/projection's and log-determinants'
    (``unpacked_mniw_kernel<24 | 48, kFactor | kProject | kLogdets>``) and, at m <=
    24, the dedup gather's (``dedup_gather_kernel``); m > 24 the dedup's
    refuses before any launch."""
    lib = _recording_lib(monkeypatch)
    N = 8
    S, phi = _CardTensor(ck.mniw.packed_rows(m, 1), N), _CardTensor(m, N)
    u, anc = _CardTensor(1, N), _CardTensor(N, dtype=torch.int32)
    ck.reset_launch_counts()
    try:
        ck.factorize_project_packed_per_thread(S, phi, 0.0, m=m, n=1)
        ck.draw_update_gather_packed_blocks_per_thread(S, None, phi, u, u, 0.0, m=m, n=1)
        ck.draw_update_gather_packed_blocks_per_thread(S, anc, phi, u, u, 0.0, m=m, n=1)
        ck.log_base_measure_packed_logdets_per_thread(S, 0.0, m=m, n=1)
        ck.project_blocks_per_thread(_CardTensor(m, m, N), _CardTensor(m, 1, N), phi)
        leaves = (_CardTensor(m, 1, N), _CardTensor(m, m, N), _CardTensor(1, 1, N))
        ck.factorize_blocks_per_thread(*leaves, 0.0)
        ck.factorize_project_blocks_per_thread(*leaves, phi, 0.0)
        ck.log_base_measure_logdets_per_thread(*leaves, 0.0)
        if m <= 24:
            ck.draw_update_dedup_gather_packed_blocks_per_thread(S, anc, phi, u, u, 0.0, m=m,
                                                                 n=1)
        else:
            with pytest.raises(ValueError, match="m <= 24"):
                ck.draw_update_dedup_gather_packed_blocks_per_thread(S, anc, phi, u, u, 0.0,
                                                                     m=m, n=1)
        counts = ck.launch_counts()
    finally:
        ck.reset_launch_counts()
    assert lib.called == ["bipk_factorize_project_packed_per_thread",
                          "bipk_draw_update_packed_per_thread",
                          "bipk_draw_update_packed_per_thread",
                          "bipk_log_base_measure_packed_per_thread",
                          "bipk_project_blocks_per_thread",
                          "bipk_factorize_blocks_per_thread",
                          "bipk_factorize_project_blocks_per_thread",
                          "bipk_log_base_measure_logdets_per_thread",
                          *(["bipk_draw_update_dedup_gather_packed_per_thread"] * (m <= 24))]
    width = "<24>" if m <= 24 else "<48>"
    for fn in (*ck.WARP[:4], ck.project_blocks, ck.factorize_blocks, ck.factorize_project_blocks,
               ck.log_base_measure_logdets):
        assert counts[f"{fn.__name__}{width}"] == 1
    if m <= 24:
        assert counts["draw_update_dedup_gather_packed_blocks<24>"] == 1
    assert sum(counts.values()) == len(lib.called)


def test_factor_pair_comparator_reaches_its_entries(monkeypatch):
    """The factor pair's per-thread comparator, given (stand-ins for) CUDA
    tensors, reaches ``bipk_factorize_project_packed_per_thread`` with an
    ``LW`` to fill (``<24, kEmit>``) and
    ``bipk_draw_update_factor_gather_packed_per_thread``
    (``factor_gather_kernel``), counted ``[emit]<24>`` and ``<24>``; with
    no warp key, and m > 24 refused before any launch."""
    lib = _recording_lib(monkeypatch)
    m, n, N = 20, 1, 8
    S, phi, u = _CardTensor(ck.mniw.packed_rows(m, n), N), _CardTensor(m, N), _CardTensor(n, N)
    LW, anc = _CardTensor(ck.mniw.lw_rows(m, n), N), _CardTensor(N, dtype=torch.int32)
    ck.reset_launch_counts()
    try:
        out = ck.factorize_project_packed_per_thread(S, phi, 0.0, m=m, n=n, emit_factor=True)
        ck.draw_update_factor_gather_packed_blocks_per_thread(S, LW, anc, phi, u, u, 0.0,
                                                              m=m, n=n)
        counts = ck.launch_counts()
    finally:
        ck.reset_launch_counts()
    assert len(out) == 6 and tuple(out[5].shape) == (ck.mniw.lw_rows(m, n), N)
    assert lib.called == ["bipk_factorize_project_packed_per_thread",
                          "bipk_draw_update_factor_gather_packed_per_thread"]
    assert counts["factorize_project_packed[emit]<24>"] == 1
    assert counts["draw_update_factor_gather_packed_blocks<24>"] == 1
    assert sum(counts.values()) == 2
    S25 = _CardTensor(ck.mniw.packed_rows(25, n), N)
    with pytest.raises(ValueError, match="m <= 24"):
        ck.factorize_project_packed_per_thread(S25, _CardTensor(25, N), 0.0, m=25, n=n,
                                               emit_factor=True)
    assert len(lib.called) == 2


def test_per_thread_comparator_is_called_by_no_module_of_the_port():
    """The comparator functions are referenced only by their own
    definitions in ``ops/cuda_kernels.py`` (``chip_smoke.py`` calls them
    from outside the package)."""
    names = ("factorize_project_packed_per_thread", "draw_update_gather_packed_blocks_per_thread",
             "log_base_measure_packed_logdets_per_thread",
             "systematic_ancestors_blocks_per_thread",
             "draw_update_factor_gather_packed_blocks_per_thread",
             "draw_update_dedup_gather_packed_blocks_per_thread", "project_blocks_per_thread",
             "factorize_blocks_per_thread", "factorize_project_blocks_per_thread",
             "log_base_measure_logdets_per_thread",
             "bipk_factorize_project_packed_per_thread", "bipk_draw_update_packed_per_thread",
             "bipk_log_base_measure_packed_per_thread", "bipk_systematic_ancestors_per_thread",
             "bipk_draw_update_factor_gather_packed_per_thread",
             "bipk_draw_update_dedup_gather_packed_per_thread",
             "bipk_project_blocks_per_thread", "bipk_factorize_blocks_per_thread",
             "bipk_factorize_project_blocks_per_thread",
             "bipk_log_base_measure_logdets_per_thread")
    for path in sorted((REPO / "bipk_tpu_torch").rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        own = set()
        if path.name == "cuda_kernels.py":
            for node in tree.body:
                if isinstance(node, ast.FunctionDef) and node.name in names:
                    own |= {id(sub) for sub in ast.walk(node)}
        for node in ast.walk(tree):
            text = node.id if isinstance(node, ast.Name) else (
                node.attr if isinstance(node, ast.Attribute) else None)
            if text in names:
                assert id(node) in own, (path, text, node.lineno)


@pytest.mark.parametrize("n", [1, 200, 32768, 1 << 20])
def test_resampler_reaches_the_scan_kernel_only(monkeypatch, n):
    """On a CUDA tensor the resampler's wrapper reaches the scan kernel's
    C entry (``bipk_systematic_ancestors``) and counts it under its own
    key; the per-thread comparator reaches its own entry and counts under
    ``"systematic_ancestors_blocks_per_thread"``, which no path launch
    touches."""
    lib = _recording_lib(monkeypatch)
    w, u = _CardTensor(n), _CardTensor(1)
    ck.reset_launch_counts()
    try:
        ck.systematic_ancestors_blocks(w, u, n)
        path = ck.launch_counts()
        ck.systematic_ancestors_blocks_per_thread(w, u, n)
        both = ck.launch_counts()
    finally:
        ck.reset_launch_counts()
    assert lib.called == ["bipk_systematic_ancestors", "bipk_systematic_ancestors_per_thread"]
    assert path["systematic_ancestors_blocks"] == 1
    assert path["systematic_ancestors_blocks_per_thread"] == 0
    assert sum(path.values()) == 1
    assert both["systematic_ancestors_blocks"] == 1
    assert both["systematic_ancestors_blocks_per_thread"] == 1
    assert sum(both.values()) == 2


@pytest.mark.parametrize("resident,layout", [(None, -1), (False, 0), (True, 1)])
def test_resampler_layout_reaches_the_entry(monkeypatch, resident, layout):
    """``resident`` of the resampler's wrapper reaches its C entry as the
    layout (-1: the entry's choice by n, 0: streamed, 1: resident), and
    every layout counts as the scan kernel."""
    _recording_lib(monkeypatch)
    seen = []
    monkeypatch.setattr(ck, "_lib", lambda: type("Lib", (), {
        "bipk_systematic_ancestors": staticmethod(lambda *args: seen.append(args) or 0)}))
    ck.reset_launch_counts()
    try:
        ck.systematic_ancestors_blocks(_CardTensor(200), _CardTensor(1), 200, resident=resident)
        counts = ck.launch_counts()
    finally:
        ck.reset_launch_counts()
    assert [args[2:4] for args in seen] == [(200, layout)]
    assert counts["systematic_ancestors_blocks"] == 1 and sum(counts.values()) == 1


def test_per_thread_comparator_needs_a_card():
    S = torch.zeros((ck.mniw.packed_rows(41, 1), 4))
    phi, u = torch.zeros((41, 4)), torch.zeros((1, 4))
    with pytest.raises(ValueError, match="CUDA tensor only"):
        ck.factorize_project_packed_per_thread(S, phi, 0.0, m=41, n=1)
    with pytest.raises(ValueError, match="CUDA tensor only"):
        ck.draw_update_gather_packed_blocks_per_thread(S, None, phi, u, u, 0.0, m=41, n=1)
    with pytest.raises(ValueError, match="CUDA tensor only"):
        ck.log_base_measure_packed_logdets_per_thread(S, 0.0, m=41, n=1)
    with pytest.raises(ValueError, match="CUDA tensor only"):
        ck.systematic_ancestors_blocks_per_thread(torch.ones(7), torch.zeros(1), 7)
    leaves = torch.zeros((41, 1, 4)), torch.zeros((41, 41, 4)), torch.zeros((1, 1, 4))
    with pytest.raises(ValueError, match="CUDA tensor only"):
        ck.factorize_blocks_per_thread(*leaves, 0.0)
    with pytest.raises(ValueError, match="CUDA tensor only"):
        ck.factorize_project_blocks_per_thread(*leaves, phi, 0.0)
    with pytest.raises(ValueError, match="CUDA tensor only"):
        ck.log_base_measure_logdets_per_thread(*leaves, 0.0)


def test_kernels_take_decides_by_device_dtype_and_width():
    """The dispatch rule itself: the kernel on a CUDA float32 tensor in
    range; the plain version on a CPU tensor (any dtype or width) or with
    ``plain=True`` (on the card too); a CUDA float64 tensor raises."""
    from bipk_tpu_torch.ops import mniw

    assert mniw.kernels_take("f", _CardTensor(1), 48, 2, False)
    assert not mniw.kernels_take("f", _CardTensor(1, dtype=torch.float64), 20, 1, True)
    assert not mniw.kernels_take("f", _CardTensor(1), 49, 3, True)
    for dtype in (torch.float32, torch.float64):
        assert not mniw.kernels_take("f", torch.zeros(1, dtype=dtype), 49, 3, False)
    with pytest.raises(TypeError, match="plain=True"):
        mniw.kernels_take("f", _CardTensor(1, dtype=torch.float64), 20, 1, False)


def test_log_base_measure_wrapper_checks_its_bounds():
    with pytest.raises(ValueError, match="m <= 48"):
        ck.log_base_measure_packed_logdets(torch.zeros((1, 8)), 0.0, m=49, n=1)
    with pytest.raises(ValueError, match="n <= 2"):
        ck.log_base_measure_packed_logdets(torch.zeros((1, 8)), 0.0, m=5, n=3)
    with pytest.raises(ValueError, match="device"):
        ck.log_base_measure_packed_logdets(torch.zeros((232, 8), device="meta"), 0.0, m=20, n=1)


@pytest.mark.parametrize("wrapper", ["factorize_blocks", "factorize_project_blocks",
                                     "log_base_measure_logdets"])
def test_unpacked_wrappers_check_their_bounds(wrapper):
    fn = getattr(ck, wrapper)
    phi = (torch.zeros((20, 8)),) if wrapper == "factorize_project_blocks" else ()

    def call(T0, T1, T2, **kw):
        return fn(T0, T1, T2, *phi, 0.0, **kw)

    def leaves(m, n, N=8, **kw):
        return torch.zeros((m, n, N), **kw), torch.zeros((m, m, N), **kw), torch.zeros((n, n, N), **kw)

    with pytest.raises(ValueError, match="m <= 48"):
        call(*leaves(49, 1))
    with pytest.raises(ValueError, match="n <= 2"):
        call(*leaves(5, 3))
    with pytest.raises(ValueError, match="T1 must be"):
        call(torch.zeros((20, 1, 8)), torch.zeros((20, 20, 9)), torch.zeros((1, 1, 8)))
    with pytest.raises(ValueError, match="device"):
        call(*leaves(20, 1, device="meta"))
    if wrapper == "factorize_blocks":
        with pytest.raises(ValueError, match="structured"):
            call(torch.zeros((20, 8)), torch.zeros((400, 8)), torch.zeros((1, 8)))
    else:
        with pytest.raises(ValueError, match="need m and n"):
            call(torch.zeros((20, 8)), torch.zeros((400, 8)), torch.zeros((1, 8)))
        with pytest.raises(ValueError, match="T0 must be"):
            call(torch.zeros((21, 8)), torch.zeros((400, 8)), torch.zeros((1, 8)), m=20, n=1)


def test_project_wrapper_checks_its_bounds():
    N = 8
    with pytest.raises(ValueError, match="chol must be"):
        ck.project_blocks(torch.zeros((20, 19, N)), torch.zeros((20, 1, N)), torch.zeros((20, N)))
    with pytest.raises(ValueError, match="m <= 48"):
        ck.project_blocks(torch.zeros((49, 49, N)), torch.zeros((49, 1, N)), torch.zeros((49, N)))
    with pytest.raises(ValueError, match="n <= 2"):
        ck.project_blocks(torch.zeros((5, 5, N)), torch.zeros((5, 3, N)), torch.zeros((5, N)))
    with pytest.raises(ValueError, match="device"):
        ck.project_blocks(torch.zeros((20, 20, N), device="meta"),
                          torch.zeros((20, 1, N), device="meta"), torch.zeros((20, N), device="meta"))


def test_unpacked_launches_count_per_instantiation():
    """The unpacked wrappers count launches per width (the projection from
    a given factor, the factorization, the factorization/projection and
    the log-determinants by their warp kernel's, ``<24w>`` / ``<48w>``,
    and their per-thread comparator's, ``<24>`` / ``<48>``), and the CPU
    ones (plain versions) count none."""
    ck.reset_launch_counts()
    try:
        ck._count(ck.project_blocks, 20)
        ck._count(ck.project_blocks, 41)
        ck._count(ck.project_blocks, 41, per_thread=True)
        ck._count(ck.factorize_blocks, 24)
        ck._count(ck.factorize_blocks, 41, per_thread=True)
        ck._count(ck.factorize_project_blocks, 48)
        ck._count(ck.factorize_project_blocks, 20, per_thread=True)
        ck._count(ck.log_base_measure_logdets, 41)
        ck._count(ck.log_base_measure_logdets, 20, per_thread=True)
        counts = ck.launch_counts()
        assert counts["project_blocks<24w>"] == 1 and counts["project_blocks<48w>"] == 1
        assert counts["project_blocks<24>"] == 0 and counts["project_blocks<48>"] == 1
        assert counts["factorize_blocks<24w>"] == 1 and counts["factorize_blocks<48>"] == 1
        assert counts["factorize_blocks<24>"] == 0 and counts["factorize_blocks<48w>"] == 0
        assert counts["factorize_project_blocks<48w>"] == 1
        assert counts["factorize_project_blocks<24>"] == 1
        assert counts["log_base_measure_logdets<48w>"] == 1
        assert counts["log_base_measure_logdets<24>"] == 1
        assert counts["log_base_measure_logdets<48>"] == 0
        assert counts["log_base_measure_logdets<24w>"] == 0
        assert sum(counts.values()) == 9
    finally:
        ck.reset_launch_counts()
    F = torch.eye(21)[:, :, None].expand(21, 21, 4).contiguous()
    ck.project_blocks(F[:20, :20], F[20:, :20].transpose(0, 1), torch.ones((20, 4)))
    ck.factorize_blocks(F[:20, 20:21], F[:20, :20], F[20:, 20:], 0.0)
    assert sum(ck.launch_counts().values()) == 0


def test_unported_modes_raise():
    """The chain mesh raises, naming ROADMAP Queue A item 2; W ranks, the
    exact scheme, the chunked and the windowed modes are ported
    (``tests/test_torch_sharded_apf.py``, ``tests/test_torch_chunked_apf.py``)
    and build."""
    from bipk_tpu_torch.parallel.mesh import ParticleMesh, chain_mesh, chain_sharding

    model = tveh.make_model(tveh.VehicleConfig(t_end=0.1))
    for fn in (chain_mesh, chain_sharding):
        with pytest.raises(NotImplementedError, match="Queue A item 2"):
            fn()
    four = ParticleMesh(None, 0, 4, torch.device("cpu"))
    for kwargs in (dict(mesh=four), dict(resampling_scheme="exact"), dict(chunk_size=32),
                   dict(window=8)):
        build_sharded_apf(model.ssm, model.gps, 64, device="cpu", **kwargs)


def test_cuda_process_group_raises_without_a_card(monkeypatch):
    """``init_distributed`` on CUDA raises without a card, before it makes
    any group: it never hands back a gloo or CPU group in its place."""
    import torch.distributed as dist

    from bipk_tpu_torch.parallel.distributed import init_distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kwargs in (dict(), dict(backend="nccl"), dict(backend="gloo"),
                   dict(init_method="file:///nonexistent/store", world_size=1, rank=0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            init_distributed(**kwargs)  # default device: cuda
        assert not dist.is_initialized()


def test_wrappers_refuse_other_devices_and_bad_shapes():
    S = torch.zeros((232, 8), device="meta")
    with pytest.raises(ValueError, match="device"):
        ck.factorize_project_packed(S, torch.zeros((20, 8), device="meta"), 0.0, m=20, n=1)
    with pytest.raises(ValueError, match="packed_rows"):
        ck.draw_update_packed_blocks(torch.zeros((231, 8)), None, None, None, 0.0, m=20, n=1)
    with pytest.raises(ValueError, match="m <= 48"):
        ck.factorize_project_packed(torch.zeros((1, 8)), None, 0.0, m=49, n=1)


def test_factor_pair_and_dedup_wrappers_check_their_bounds():
    rows, rows_lw = ck.mniw.packed_rows(20, 1), ck.mniw.lw_rows(20, 1)
    anc = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="LW must be"):
        ck.draw_update_factor_gather_packed_blocks(
            torch.zeros((rows, 8)), torch.zeros((rows_lw - 1, 8)), anc, None, None, None,
            0.0, m=20, n=1)
    with pytest.raises(ValueError, match="LW must be"):
        ck.draw_update_factor_gather_packed_blocks(
            torch.zeros((rows, 8)), torch.zeros((rows_lw, 9)), anc, None, None, None,
            0.0, m=20, n=1)
    S41 = torch.zeros((ck.mniw.packed_rows(41, 1), 8))
    with pytest.raises(ValueError, match="m <= 24"):
        ck.draw_update_factor_gather_packed_blocks(
            S41, torch.zeros((ck.mniw.lw_rows(41, 1), 8)), anc, None, None, None, 0.0,
            m=41, n=1)
    with pytest.raises(ValueError, match="m <= 24"):
        ck.draw_update_dedup_gather_packed_blocks(S41, anc, None, None, None, 0.0, m=41, n=1)
    with pytest.raises(ValueError, match="m <= 24"):
        ck.factorize_project_packed(S41, None, 0.0, m=41, n=1, emit_factor=True)
    with pytest.raises(ValueError, match="device"):
        ck.draw_update_dedup_gather_packed_blocks(
            torch.zeros((rows, 8), device="meta"), anc, None, None, None, 0.0, m=20, n=1)


def test_dedup_stage_budget_matches_the_kernel():
    """``dedup_runs`` reports the distinct columns each block of the warp
    dedup gather reads by the kernel's own rule: runs of equal neighbouring
    ancestors, a block's first particle starting one, so a value seen
    again (out of order) starts another. The stage needs no budget: the
    kernel stages every block's runs in its particles' triangles, which
    ``tests/test_torch_dedup_project_rehearsal.py`` checks by the plan."""
    src = (REPO / "bipk_tpu_torch" / "csrc" / "warp_mniw.cu").read_text()
    assert "const bool starts = live && (t == 0 || left != col);" in src
    assert "float* stage = smem + p.tile_floats;" in src
    # 128 distinct ancestors, then 128 copies of one: blocks of 16
    anc = torch.cat([torch.arange(128), torch.full((128,), 200)]).int()
    assert ck.dedup_runs(anc, 16).tolist() == [16] * 8 + [1] * 8
    # a ragged last block, and a value seen again out of order
    anc = torch.tensor([3, 3, 5, 3, 3, 7, 7], dtype=torch.int32)
    assert ck.dedup_runs(anc, 4).tolist() == [3, 2]


@pytest.mark.parametrize("option", ["reuse_factor", "dedup_gather"])
def test_build_functions_take_the_opt_in_kernels_on_the_cpu(option):
    model = tveh.make_model(tveh.VehicleConfig(t_end=0.1))
    for build in (build_sharded_apf, build_apf, build_csmc):
        kern = build(model.ssm, model.gps, 64, device="cpu", **{option: True}).kern
        assert getattr(kern, option) and kern.device.type == "cpu"
    gibbs = build_gibbs(model.ssm, model.gps, 64, 3, device="cpu", **{option: True})
    assert getattr(gibbs.kern, option)


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


def test_library_name_tracks_the_sources(monkeypatch, tmp_path):
    before = _build.library_path()
    src = tmp_path / "csrc"
    src.mkdir()
    for f in _build.sources():
        (src / f.name).write_bytes(f.read_bytes() + b"\n// edited\n")
    monkeypatch.setattr(_build, "CSRC_DIR", src)
    assert _build.library_path() != before
    assert _build.library_path().name.startswith("libbipk_kernels_")


def test_packaging_names_both_packages():
    cfg = tomllib.loads((REPO / "pyproject.toml").read_text())["tool"]["setuptools"]
    found = set(find_packages(str(REPO), include=cfg["packages"]["find"]["include"]))
    assert {"bipk_tpu", "bipk_tpu_torch", "bipk_tpu_torch.ops"} <= found
    assert "csrc/*.cu" in cfg["package-data"]["bipk_tpu_torch"]
