"""The vehicle configuration (``vehicle.json``) as the measured package
builds it: its model, and the record simulated from a seed.

The package's own constants have to be the file's; a run of another
configuration than the one stated raises.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch


def _same(name, got, want):
    if not np.allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                       rtol=1e-12, atol=0.0):
        raise ValueError(f"the package's {name} is {got}, the configuration states {want}")


def _module():
    from bipk_tpu_torch.models import vehicle as veh

    return veh


def _config(cfg):
    veh = _module()
    p = cfg["physics"]
    for name, key in (("M", "mass"), ("I_ZZ", "inertia_zz"), ("L_F", "l_front"),
                      ("L_R", "l_rear"), ("G", "gravity"), ("MU_X", "mu_x"), ("MU", "mu"),
                      ("PACEJKA_B", "pacejka_b"), ("PACEJKA_C", "pacejka_c"),
                      ("PACEJKA_E", "pacejka_e")):
        _same(name, getattr(veh, name), p[key])
    _same("Q", veh.Q, cfg["process_noise"])
    _same("R", veh.R, cfg["output_noise"])
    _same("P0_MU", veh.P0_MU, cfg["init_gp_cov"])
    if cfg["precision"] != "float32" or cfg["tf32"]:
        raise ValueError("the package's filters run float32 without TF32")
    return veh.VehicleConfig(
        n_basis=cfg["n_basis"], domain_deg=cfg["domain_deg"],
        lengthscale_deg=cfg["lengthscale_deg"], magnitude=cfg["magnitude"],
        prior_df=cfg["prior_df"], forgetting_factor=cfg["forgetting_factor"], dt=cfg["dt"],
        t_end=cfg["t_end"], speed=cfg["speed"])


def program(cfg, device):
    """The package's model: ``ssm``, ``gps``, the initial state's mean and
    covariance, the forgetting factor and every GP's ``(m, n)``."""
    model = _module().make_model(_config(cfg))
    _same("x0", model.x0, cfg["init_state_mean"])
    _same("p0", model.p0, cfg["init_state_cov"])
    return SimpleNamespace(ssm=model.ssm, gps=model.gps, x0=model.x0, p0=model.p0,
                           lam=cfg["forgetting_factor"],
                           gp_shapes=[(gp.basis_dim, gp.out_dim) for gp in model.gps])


def record(cfg, seed, device):
    """The record simulated from ``seed`` by the package's ``simulate``:
    states ``X (T, 2)``, observations ``Y (T, 2)``, inputs ``U (T, 2)`` and
    the true GP values ``G`` (front and rear friction, each ``(T, 1)``)."""
    gen = torch.Generator().manual_seed(seed % (1 << 63))
    X, Y, mu_f, mu_r, U = _module().simulate(gen, _config(cfg), dtype=torch.float32,
                                             device=device)
    return SimpleNamespace(X=X, Y=Y, U=U, G=[mu_f[:, None], mu_r[:, None]])
