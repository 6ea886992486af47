"""Batched MPC: double-integrator path tracking as a box-QP solved by ADMM.

PyTorch counterpart of ``red_gym_tpu/agents/mpc.py`` (reference:
src/SAL.py:615-739 and src/MPC/MPC.py, a cvxpy/OSQP problem solved on the
host every control step).  The problem is tiny and of fixed shape (horizon
5, a 2-D double integrator, |u| <= 1 box): the QP is condensed into the
control variables and solved by ADMM with a fixed iteration count, for E
paths at once.  The JAX package solves one path and vmaps; here every
function takes a leading path axis E.

The condensed Hessian and its Cholesky factor depend only on the dynamics,
the weights, the horizon and dt, never on the path, so
:func:`condensed_qp` builds them once (``PlanningEnv`` caches them where
the env is built) and each of the ADMM's iterations is one
``torch.cholesky_solve`` of an (E, 10, 1) right-hand side.

The not-a-knot cubic spline reference trajectory matches scipy's
CubicSpline (the reference's interpolator, SAL.py:643-644).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


# ---------------------------------------------------------------------------
# Not-a-knot cubic spline, matching scipy.interpolate.CubicSpline
# ---------------------------------------------------------------------------


def spline_moments(xs, ys):
    """Second derivatives (moments) of the not-a-knot cubic spline of each
    path: xs (E, N) strictly increasing, ys (E, N) -> M (E, N)."""
    e_n, n = xs.shape
    h = xs[:, 1:] - xs[:, :-1]                       # (E, N-1)
    a = torch.zeros((e_n, n, n), dtype=ys.dtype, device=ys.device)
    b = torch.zeros((e_n, n), dtype=ys.dtype, device=ys.device)
    # interior moment equations
    i = torch.arange(1, n - 1, device=ys.device)
    a[:, i, i - 1] = h[:, :-1] / 6.0
    a[:, i, i] = (h[:, :-1] + h[:, 1:]) / 3.0
    a[:, i, i + 1] = h[:, 1:] / 6.0
    b[:, 1:-1] = ((ys[:, 2:] - ys[:, 1:-1]) / h[:, 1:]
                  - (ys[:, 1:-1] - ys[:, :-2]) / h[:, :-1])
    # not-a-knot: third derivative continuous at x1 and x_{n-2}
    a[:, 0, 0] = h[:, 1]
    a[:, 0, 1] = -(h[:, 0] + h[:, 1])
    a[:, 0, 2] = h[:, 0]
    a[:, n - 1, n - 3] = h[:, -1]
    a[:, n - 1, n - 2] = -(h[:, -2] + h[:, -1])
    a[:, n - 1, n - 1] = h[:, -2]
    return torch.linalg.solve(a, b)


class Spline(NamedTuple):
    xs: torch.Tensor   # (E, N)
    ys: torch.Tensor   # (E, N)
    m: torch.Tensor    # (E, N) moments


def spline_fit(xs, ys) -> Spline:
    return Spline(xs, ys, spline_moments(xs, ys))


def spline_eval(sp: Spline, x):
    """Value and first derivative at x (E, Q), with the standard moment-form
    piecewise cubic -> (y (E, Q), dy (E, Q))."""
    xs, ys, m = sp
    i = torch.clamp(torch.searchsorted(xs.contiguous(), x.contiguous(), right=True) - 1,
                    0, xs.shape[-1] - 2)
    g = lambda v, j: torch.gather(v, 1, j)  # noqa: E731
    x0, x1 = g(xs, i), g(xs, i + 1)
    y0, y1 = g(ys, i), g(ys, i + 1)
    m0, m1 = g(m, i), g(m, i + 1)
    h = x1 - x0
    t0 = x - x0
    t1 = x1 - x
    y = (m0 * t1**3 + m1 * t0**3) / (6 * h) \
        + (y0 / h - m0 * h / 6) * t1 + (y1 / h - m1 * h / 6) * t0
    dy = (-m0 * t1**2 + m1 * t0**2) / (2 * h) \
        - (y0 / h - m0 * h / 6) + (y1 / h - m1 * h / 6)
    return y, dy


# ---------------------------------------------------------------------------
# Condensed box-QP via ADMM
# ---------------------------------------------------------------------------


def _condense(A, B, Q, R, Qf, horizon):
    """Stack the dynamics: x = Phi x0 + Gamma u_flat; return (H, Phi, Gamma,
    Qbar) for the condensed quadratic 0.5 u'Hu + (x0, ref)-dependent linear
    term computed at solve time."""
    nx, nu = B.shape
    Phi = torch.cat([torch.linalg.matrix_power(A, k + 1)
                     for k in range(horizon)], dim=0)                  # (H*nx, nx)
    blocks = []
    for r in range(horizon):
        row = []
        for c in range(horizon):
            if c <= r:
                row.append(torch.linalg.matrix_power(A, r - c) @ B)
            else:
                row.append(torch.zeros((nx, nu), dtype=B.dtype, device=B.device))
        blocks.append(torch.cat(row, dim=1))
    Gamma = torch.cat(blocks, dim=0)                                   # (H*nx, H*nu)

    Qbar = torch.block_diag(*([Q] * (horizon - 1) + [Qf]))                     # (H*nx, H*nx)
    Rbar = torch.block_diag(*([R] * horizon))
    Hmat = Gamma.T @ Qbar @ Gamma + Rbar
    return Hmat, Phi, Gamma, Qbar


class CondensedQP(NamedTuple):
    """What a control step needs that does not depend on the path."""

    A: torch.Tensor      # (4, 4) double-integrator step
    B: torch.Tensor      # (4, 2)
    Hmat: torch.Tensor   # (2H, 2H) condensed Hessian
    Phi: torch.Tensor    # (4H, 4)
    GtQ: torch.Tensor    # (2H, 4H) Gamma' Qbar
    L: torch.Tensor      # (2H, 2H) lower Cholesky factor of Hmat + rho I
    rho: float


def condensed_qp(timestep, Q, R, Qf, horizon: int, rho: float = 1.0) -> CondensedQP:
    """The condensed QP of the SAL double integrator at ``timestep`` (a 0-d
    tensor of the controller's dtype and device) and its ADMM factor."""
    dt = timestep
    dtype, dev = Q.dtype, Q.device
    one, zero = torch.ones((), dtype=dtype, device=dev), torch.zeros((), dtype=dtype, device=dev)
    A = torch.stack([torch.stack([one, zero, dt, zero]), torch.stack([zero, one, zero, dt]),
                     torch.stack([zero, zero, one, zero]), torch.stack([zero, zero, zero, one])])
    half = 0.5 * dt**2
    B = torch.stack([torch.stack([half, zero]), torch.stack([zero, half]),
                     torch.stack([dt, zero]), torch.stack([zero, dt])])
    Hmat, Phi, Gamma, Qbar = _condense(A, B, Q, R, Qf, horizon)
    n = Hmat.shape[0]
    L = torch.linalg.cholesky(Hmat + rho * torch.eye(n, dtype=dtype, device=dev))
    return CondensedQP(A, B, Hmat, Phi, Gamma.T @ Qbar, L, rho)


def admm_box_qp(Hmat, g, lo, hi, rho: float = 1.0, iters: int = 60, L=None):
    """min 0.5 u'Hu + g'u  s.t. lo <= u <= hi for each row of g (E, n), via
    scaled ADMM with a Cholesky factor of Hmat + rho I (``L``, computed
    here if not given) -> (E, n).  A fixed iteration count, no host sync."""
    dt = Hmat.dtype
    if L is None:
        n = Hmat.shape[0]
        L = torch.linalg.cholesky(Hmat + rho * torch.eye(n, dtype=dt, device=Hmat.device))
    g = g.to(dt)[..., None]                                            # (E, n, 1)
    lo, hi = lo[:, None], hi[:, None]
    z = torch.zeros_like(g)
    lam = torch.zeros_like(g)
    for _ in range(iters):
        rhs = -g + rho * (z - lam)
        u = torch.cholesky_solve(rhs, L)
        z = torch.minimum(torch.maximum(u + lam, lo), hi)
        lam = lam + u - z
    return z[..., 0]


class MPCConfig(NamedTuple):
    desired_velocity: torch.Tensor
    timestep: torch.Tensor
    total_steps: int
    horizon: int
    Q: torch.Tensor
    R: torch.Tensor
    Qf: torch.Tensor


def default_mpc_config(dtype=torch.float32) -> MPCConfig:
    """The SAL MPC parameters (SAL.py:37-45), as tiny constants on the CPU;
    ``PlanningEnv`` moves them to its env's device."""
    t = lambda v: torch.as_tensor(v, dtype=dtype)  # noqa: E731
    return MPCConfig(
        desired_velocity=t(2.0),
        timestep=t(0.1),
        total_steps=10,
        horizon=5,
        Q=torch.diag(t([1.0, 1.0, 0.1, 0.1])),
        R=torch.diag(t([0.1, 0.1])),
        Qf=torch.diag(t([10.0, 10.0, 1.0, 1.0])),
    )


def mpc_controller(path, desired_velocity, timestep, Q, R, Qf,
                   total_steps: int = 10, horizon: int = 5,
                   current_vel_x=0.0, current_vel_y=0.0, admm_iters: int = 60,
                   qp: Optional[CondensedQP] = None):
    """Control sequences along E paths (reference MPC_controller,
    SAL.py:615-739).

    path (E, K, 2) -> u_history (E, total_steps, 2): receding-horizon
    solutions of the condensed box-QP, rolling each double-integrator state
    forward with the first control of each solve.  ``current_vel_x``/``_y``
    are (E,) or scalars; ``qp`` is :func:`condensed_qp` of these weights,
    built here if not given."""
    dt = timestep
    dtype, dev = path.dtype, path.device
    e_n = path.shape[0]
    if qp is None:
        qp = condensed_qp(dt, Q, R, Qf, horizon)

    # arc-length parametrization + not-a-knot splines (SAL.py:632-644)
    seglen = torch.linalg.vector_norm(path[:, 1:] - path[:, :-1], dim=-1)
    dists = torch.cat([torch.zeros((e_n, 1), dtype=dtype, device=dev),
                       torch.cumsum(seglen, dim=1)], dim=1)
    sp_x = spline_fit(dists, path[..., 0])
    sp_y = spline_fit(dists, path[..., 1])

    # reference trajectory at constant arc speed (SAL.py:660-686)
    n_ref = total_steps + horizon + 1
    t_grid = torch.arange(n_ref, dtype=dtype, device=dev) * dt
    s = torch.minimum((desired_velocity * t_grid)[None, :], dists[:, -1:])
    x_ref, vx_ref = spline_eval(sp_x, s)
    y_ref, vy_ref = spline_eval(sp_y, s)
    speed = torch.hypot(vx_ref, vy_ref)
    scale = torch.where(speed > 1e-3, desired_velocity / speed, torch.zeros_like(speed))
    ref = torch.stack([x_ref, y_ref, vx_ref * scale, vy_ref * scale], dim=-1)  # (E, n_ref, 4)

    n_u = horizon * 2
    lo = -torch.ones((n_u,), dtype=dtype, device=dev)
    hi = torch.ones((n_u,), dtype=dtype, device=dev)
    vx = torch.broadcast_to(torch.as_tensor(current_vel_x, dtype=dtype, device=dev), (e_n,))
    vy = torch.broadcast_to(torch.as_tensor(current_vel_y, dtype=dtype, device=dev), (e_n,))
    x_cur = torch.stack([path[:, 0, 0], path[:, 0, 1], vx, vy], dim=-1)      # (E, 4)

    u_hist = []
    for t in range(total_steps):
        r_flat = ref[:, t + 1:t + 1 + horizon].reshape(e_n, -1)
        g = (x_cur @ qp.Phi.T - r_flat) @ qp.GtQ.T
        u_flat = admm_box_qp(qp.Hmat, g, lo, hi, rho=qp.rho, iters=admm_iters, L=qp.L)
        u0 = u_flat[:, :2]
        x_cur = x_cur @ qp.A.T + u0 @ qp.B.T
        u_hist.append(u0)
    return torch.stack(u_hist, dim=1)


def mpc_converter(x_accel, y_accel, current_speed, current_steer,
                  max_steer, max_accel, max_velo, min_velo):
    """(ax, ay) -> [steering, throttle] (..., 2) (reference MPC_converter,
    SAL.py:741-764)."""
    current_steer = torch.as_tensor(current_steer, dtype=x_accel.dtype, device=x_accel.device)
    target_angle = torch.atan2(y_accel, x_accel)
    angle_diff = torch.remainder(target_angle - current_steer + torch.pi,
                                 2 * torch.pi) - torch.pi
    steering = torch.clamp(angle_diff, -max_steer, max_steer)
    forward = x_accel * torch.cos(current_steer) + y_accel * torch.sin(current_steer)
    throttle = torch.clamp(forward, -1.0, 1.0)
    return torch.stack([steering, throttle], dim=-1)
