"""Carry a model and a particle carry across from the JAX package, as numpy.

The port never imports JAX. A caller that holds one of the JAX package's
models exports its arrays with ``np.asarray`` into the plain dictionary
that ``<model>_model_from_arrays`` reads (:func:`vehicle_arrays`,
:func:`oscillator_arrays` and :func:`toy_arrays` do it), and the two
packages then compute the same thing from the same inputs. The keys (the
oscillator and the toy have one GP, ``model.gp``, in place of
``model.gps``):

==================  ==========================================================
key                 JAX source
==================  ==========================================================
sqrt_eigenvalues    ``model.basis.sqrt_eigenvalues`` ``(m, d)``
centers             ``model.basis.centers`` ``(d,)``
half_widths         ``model.basis.half_widths`` ``(d,)``
spectral_density    ``model.basis.spectral_density`` ``(m,)``
priors              ``[gp.prior for gp in model.gps]`` as ``(T0, T1, T2, T3)``
process_noise       ``model.ssm.process_noise``
output_noise        ``model.ssm.output_noise``
init_cov            ``model.gps[0].init_cov``
init_mean           ``model.gp.init_mean`` (the toy only)
x0, p0              ``model.x0``, ``model.p0``
==================  ==========================================================

EMPS (:func:`emps_arrays`) adds its data (``data_time``, ``data_states``,
``data_observations``, ``data_inputs``, ``data_dt``, ``data_synthetic``:
the fields of ``model.data``) and its classic-PGAS baseline
(``baseline_sqrt_eigenvalues``, ``baseline_centers``,
``baseline_half_widths``, ``baseline_spectral_density`` of
``model.baseline_basis``, and ``baseline_prior``, ``(T0, T1, T2, T3)``).
"""

from __future__ import annotations

import numpy as np
import torch

from bipk_tpu_torch.models import emps, oscillator, toy, vehicle
from bipk_tpu_torch.ops import basis as basis_ops
from bipk_tpu_torch.ops import mniw


def _model_arrays(model, gps) -> dict:
    """The arrays every model has: basis constants, priors, noises, the
    initial laws."""
    return dict(
        sqrt_eigenvalues=np.asarray(model.basis.sqrt_eigenvalues),
        centers=np.asarray(model.basis.centers),
        half_widths=np.asarray(model.basis.half_widths),
        spectral_density=np.asarray(model.basis.spectral_density),
        priors=[tuple(np.asarray(p) for p in gp.prior) for gp in gps],
        process_noise=np.asarray(model.ssm.process_noise),
        output_noise=np.asarray(model.ssm.output_noise),
        init_cov=np.asarray(gps[0].init_cov),
        x0=np.asarray(model.x0),
        p0=np.asarray(model.p0),
    )


def _basis(f64: dict, prefix: str = "") -> basis_ops.HilbertBasis:
    return basis_ops.HilbertBasis(*(f64[prefix + k] for k in (
        "sqrt_eigenvalues", "centers", "half_widths", "spectral_density")))


def _mniw(prior) -> mniw.MNIW:
    return mniw.MNIW(*(np.array(p, np.float64) for p in prior))


def _parts(arrays: dict):
    """``(float64 arrays, HilbertBasis, priors)`` from the arrays."""
    f64 = {k: np.array(v, np.float64) for k, v in arrays.items() if k != "priors"}
    return f64, _basis(f64), tuple(_mniw(prior) for prior in arrays["priors"])


def vehicle_arrays(model) -> dict:
    """The arrays of a JAX ``VehicleModel`` (read by attribute, as numpy)
    that :func:`vehicle_model_from_arrays` takes."""
    return _model_arrays(model, model.gps)


def vehicle_model_from_arrays(config: dict, arrays: dict) -> vehicle.VehicleModel:
    """The port's vehicle model from the JAX model's configuration fields
    (``dataclasses.asdict``) and arrays (see the module docstring)."""
    f64, hb, priors = _parts(arrays)
    return vehicle.model_from_parts(
        vehicle.VehicleConfig(**config), hb, priors,
        process_noise=f64["process_noise"], output_noise=f64["output_noise"],
        init_cov=f64["init_cov"], x0=f64["x0"], p0=f64["p0"],
    )


def oscillator_arrays(model) -> dict:
    """The arrays of a JAX ``OscillatorModel`` that
    :func:`oscillator_model_from_arrays` takes."""
    return _model_arrays(model, (model.gp,))


def oscillator_model_from_arrays(config: dict, arrays: dict) -> oscillator.OscillatorModel:
    """The port's single-mass oscillator from the JAX model's configuration
    fields (``dataclasses.asdict``) and arrays."""
    f64, hb, (prior,) = _parts(arrays)
    return oscillator.model_from_parts(
        oscillator.OscillatorConfig(**config), hb, prior,
        process_noise=f64["process_noise"], output_noise=f64["output_noise"],
        init_cov=f64["init_cov"], x0=f64["x0"], p0=f64["p0"],
    )


def toy_arrays(model) -> dict:
    """The arrays of a JAX ``ToyModel`` that :func:`toy_model_from_arrays`
    takes (its ``x0`` and ``p0`` follow from the configuration)."""
    return dict(_model_arrays(model, (model.gp,)), init_mean=np.asarray(model.gp.init_mean))


def toy_model_from_arrays(config: dict, arrays: dict) -> toy.ToyModel:
    """The port's toy model from the JAX model's configuration fields
    (``dataclasses.asdict``) and arrays."""
    f64, hb, (prior,) = _parts(arrays)
    model = toy.model_from_parts(
        toy.ToyConfig(**config), hb, prior, output_noise=f64["output_noise"],
        init_mean=f64["init_mean"], init_cov=f64["init_cov"],
    )
    for key in ("x0", "p0"):
        if not np.array_equal(getattr(model, key), f64[key]):
            raise ValueError(f"toy {key} differs from what the configuration gives")
    return model


def emps_arrays(model) -> dict:
    """The arrays of a JAX ``EMPSModel`` (its data and its classic-PGAS
    baseline too) that :func:`emps_model_from_arrays` takes."""
    base = model.baseline_basis
    data = model.data
    return dict(
        _model_arrays(model, (model.gp,)),
        baseline_sqrt_eigenvalues=np.asarray(base.sqrt_eigenvalues),
        baseline_centers=np.asarray(base.centers),
        baseline_half_widths=np.asarray(base.half_widths),
        baseline_spectral_density=np.asarray(base.spectral_density),
        baseline_prior=tuple(np.asarray(p) for p in model.baseline_prior),
        data_time=np.asarray(data.time), data_states=np.asarray(data.states),
        data_observations=np.asarray(data.observations),
        data_inputs=np.asarray(data.inputs), data_dt=float(data.dt),
        data_synthetic=bool(data.synthetic),
    )


def emps_model_from_arrays(config: dict, arrays: dict) -> emps.EMPSModel:
    """The port's EMPS model from the JAX model's configuration fields
    (``dataclasses.asdict``) and arrays."""
    f64, hb, (prior,) = _parts({k: v for k, v in arrays.items()
                                if k not in ("baseline_prior", "data_synthetic")})
    data = emps.EMPSData(
        time=f64["data_time"], states=f64["data_states"],
        observations=f64["data_observations"], inputs=f64["data_inputs"],
        dt=float(f64["data_dt"]), synthetic=bool(arrays["data_synthetic"]),
    )
    model = emps.model_from_parts(
        emps.EMPSConfig(**config), data, hb, prior, _basis(f64, "baseline_"),
        _mniw(arrays["baseline_prior"]), process_noise=f64["process_noise"],
        output_noise=f64["output_noise"], init_cov=f64["init_cov"],
    )
    for key in ("x0", "p0"):
        if not np.array_equal(getattr(model, key), f64[key]):
            raise ValueError(f"EMPS {key} differs from what the data and the model give")
    return model


def packed_carry_from_arrays(log_weights, state, int_vars, stats, dtype, device):
    """A particle carry ``(log_weights (N,), state (dx, N), int_vars,
    stats)`` with structured batch-last statistics ``(T0 (m, n, N), T1,
    T2, T3)`` per GP, given as numpy, -> the port's carry with the
    statistics packed (``mniw.pack_stats_bl``)."""

    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    return (
        t(log_weights),
        t(state),
        tuple(t(iv) for iv in int_vars),
        tuple(mniw.pack_stats_bl(mniw.MNIW(*(t(a) for a in st))) for st in stats),
    )


def reference_from_arrays(ref_state, ref_int_vars, ref_summed_stats, dtype, device):
    """A cSMC reference from the JAX package's arrays, as numpy: the
    trajectory ``ref_state (T, dx)``, its interface variables (each ``(T,
    n_i)``) and its summed statistics (per GP ``(T0, T1, T2, T3)``, e.g.
    from ``bipk_tpu.algorithms.gibbs.summed_reference_stats``) -> the
    arguments ``build_csmc``'s sweep takes."""

    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    return (
        t(ref_state),
        tuple(t(iv) for iv in ref_int_vars),
        tuple(mniw.MNIW(*(t(a) for a in st)) for st in ref_summed_stats),
    )
