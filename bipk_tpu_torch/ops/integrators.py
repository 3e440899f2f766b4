"""Explicit ODE integrators (port of ``bipk_tpu/ops/integrators.py``)."""

from __future__ import annotations

from typing import Callable

import torch


def rk4_step(rhs: Callable, x: torch.Tensor, dt, *args) -> torch.Tensor:
    """One classic Runge-Kutta-4 step of ``dx/dt = rhs(x, *args)``."""
    k1 = rhs(x, *args)
    k2 = rhs(x + 0.5 * dt * k1, *args)
    k3 = rhs(x + 0.5 * dt * k2, *args)
    k4 = rhs(x + dt * k3, *args)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def discretize_rk4(rhs: Callable, dt) -> Callable:
    """The discrete-time map ``x -> rk4_step(rhs, x, dt, *args)``."""

    def step(x, *args):
        return rk4_step(rhs, x, dt, *args)

    return step
