"""Fixed-step time integrators for the vehicle ODE.

PyTorch counterpart of ``red_gym_tpu/ops/integrate.py`` (reference:
base_classes.py:282-402), with the reference's stage arithmetic and
floating-point ordering.  The ``_t`` forms step tuples of state components
(the env step's form); ``rk4_step``, ``euler_step`` and ``integrate`` step
a stacked state (..., n) under ``rhs(x, u, p)`` and are thin wrappers over
them.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from refsim.config import Integrator


def _taxpy(x, a, k):
    """Per-component x + a*k over state tuples."""
    return tuple(xi + a * ki for xi, ki in zip(x, k))


def rk4_step_t(rhs_t: Callable, xt, sv, ac, dt, p):
    """Classic RK4 (base_classes.py:282-371): stage states x + dt/2*k and
    the dt*(1/6)*(k1 + 2k2 + 2k3 + k4) update."""
    k1 = rhs_t(xt, sv, ac, p)
    k2 = rhs_t(_taxpy(xt, dt / 2, k1), sv, ac, p)
    k3 = rhs_t(_taxpy(xt, dt / 2, k2), sv, ac, p)
    k4 = rhs_t(_taxpy(xt, dt, k3), sv, ac, p)
    c = dt * (1.0 / 6.0)
    return tuple(x + c * (a + 2.0 * b + 2.0 * cc + d)
                 for x, a, b, cc, d in zip(xt, k1, k2, k3, k4))


def euler_step_t(rhs_t: Callable, xt, sv, ac, dt, p):
    """Explicit Euler (base_classes.py:373-393)."""
    return _taxpy(xt, dt, rhs_t(xt, sv, ac, p))


def integrate_t(integrator: Integrator, rhs_t: Callable, xt, sv, ac, dt, p):
    if integrator is Integrator.RK4:
        return rk4_step_t(rhs_t, xt, sv, ac, dt, p)
    if integrator is Integrator.EULER:
        return euler_step_t(rhs_t, xt, sv, ac, dt, p)
    raise ValueError(f"unknown integrator {integrator}")


def _stacked(rhs: Callable):
    """rhs(x, u, p) on stacked arrays as a component-tuple RHS."""
    def rhs_t(xt, sv, ac, p):
        f = rhs(torch.stack(xt, dim=-1), torch.stack([sv, ac], dim=-1), p)
        return tuple(f.unbind(-1))
    return rhs_t


def _tuple_step(step_t: Callable, rhs: Callable, x, u, dt, p):
    xt = step_t(_stacked(rhs), tuple(x.unbind(-1)), u[..., 0], u[..., 1], dt, p)
    return torch.stack(xt, dim=-1)


def rk4_step(rhs: Callable, x, u, dt, p):
    """RK4 on the stacked state (..., n) with controls (..., 2)."""
    return _tuple_step(rk4_step_t, rhs, x, u, dt, p)


def euler_step(rhs: Callable, x, u, dt, p):
    """Explicit Euler on the stacked state (..., n)."""
    return _tuple_step(euler_step_t, rhs, x, u, dt, p)


def integrate(integrator: Integrator, rhs: Callable, x, u, dt, p):
    if integrator is Integrator.RK4:
        return rk4_step(rhs, x, u, dt, p)
    if integrator is Integrator.EULER:
        return euler_step(rhs, x, u, dt, p)
    raise ValueError(f"unknown integrator {integrator}")


def wrap_yaw(yaw: torch.Tensor) -> torch.Tensor:
    """Single-step yaw wrap into [0, 2*pi): at most one correction per step,
    as the reference does (base_classes.py:399-402)."""
    two_pi = 2.0 * math.pi
    yaw = torch.where(yaw > two_pi, yaw - two_pi, yaw)
    return torch.where(yaw < 0.0, yaw + two_pi, yaw)
