"""The port's batched MPC (``red_gym_tpu_torch/agents/mpc.py``) against
scipy's CubicSpline and the JAX package's MPC (vmapped over the paths), on
the same numpy inputs, on the CPU.

Bars: float64 spline moments, values and slopes within 1e-12 (relative,
and absolute near 0) of JAX's and of scipy's (n = 4 knots make moments of
order 1e3); ``admm_box_qp`` and ``mpc_controller`` (total_steps 10 and 1,
admm_iters 60 and 200) within 1e-10 over 8 paths; ``mpc_converter`` within
1e-12; the float32 controller within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.interpolate import CubicSpline

from red_gym_tpu.agents import mpc as jmpc
from red_gym_tpu_torch.agents import mpc as tmpc

E = 8


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _knots(rng, n):
    xs = np.sort(rng.uniform(0, 10, n)) + np.arange(n) * 1e-3
    return xs, rng.normal(size=n)


def _paths(seed=0, k=8, dtype=np.float64):
    """E planning-env-like paths: unit-ish steps turning a little."""
    rng = np.random.default_rng(seed)
    ang = np.cumsum(rng.uniform(-0.4, 0.4, (E, k)), axis=1)
    step = rng.uniform(0.3, 0.7, (E, k, 1)) * np.stack([np.cos(ang), np.sin(ang)], -1)
    return (np.cumsum(step, axis=1) + rng.uniform(-5, 5, (E, 1, 2))).astype(dtype)


@pytest.mark.parametrize("n", [4, 8, 13])
def test_spline_matches_scipy_and_jax(n):
    rng = np.random.default_rng(n)
    xs, ys = map(np.stack, zip(*[_knots(rng, n) for _ in range(E)]))
    xq = np.stack([np.linspace(x[0] - 0.5, x[-1] + 0.5, 40) for x in xs])
    sp = tmpc.spline_fit(torch.from_numpy(xs), torch.from_numpy(ys))
    y, dy = tmpc.spline_eval(sp, torch.from_numpy(xq))
    for e in range(E):
        jsp = jmpc.spline_fit(jnp.asarray(xs[e]), jnp.asarray(ys[e]))
        np.testing.assert_allclose(sp.m[e].numpy(), np.asarray(jsp.m), rtol=1e-12, atol=1e-12)
        jy, jdy = jmpc.spline_eval(jsp, jnp.asarray(xq[e]))
        np.testing.assert_allclose(y[e].numpy(), np.asarray(jy), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(dy[e].numpy(), np.asarray(jdy), rtol=1e-12, atol=1e-12)
        inside = (xq[e] >= xs[e, 0]) & (xq[e] <= xs[e, -1])
        cs = CubicSpline(xs[e], ys[e])
        np.testing.assert_allclose(y[e].numpy()[inside], cs(xq[e][inside]), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(dy[e].numpy()[inside], cs.derivative()(xq[e][inside]),
                                   rtol=1e-12, atol=1e-12)


def _weights(dtype):
    jc = jmpc.default_mpc_config(jnp.float64 if dtype == np.float64 else jnp.float32)
    tc = tmpc.default_mpc_config(torch.float64 if dtype == np.float64 else torch.float32)
    return jc, tc


def test_condensed_qp_matches_jax():
    jc, tc = _weights(np.float64)
    dt = jnp.asarray(0.1, jnp.float64)
    a = jnp.array([[1, 0, dt, 0], [0, 1, 0, dt], [0, 0, 1, 0], [0, 0, 0, 1]], jnp.float64)
    b = jnp.array([[0.5 * dt**2, 0], [0, 0.5 * dt**2], [dt, 0], [0, dt]], jnp.float64)
    jh, jphi, jgam, jq = jmpc._condense(a, b, jc.Q, jc.R, jc.Qf, 5)
    qp = tmpc.condensed_qp(tc.timestep, tc.Q, tc.R, tc.Qf, 5)
    np.testing.assert_allclose(qp.Hmat.numpy(), np.asarray(jh), rtol=0, atol=1e-12)
    np.testing.assert_allclose(qp.Phi.numpy(), np.asarray(jphi), rtol=0, atol=1e-12)
    np.testing.assert_allclose(qp.GtQ.numpy(), np.asarray(jgam.T @ jq), rtol=0, atol=1e-12)
    np.testing.assert_allclose(qp.A.numpy(), np.asarray(a), rtol=0, atol=0)
    np.testing.assert_allclose(qp.B.numpy(), np.asarray(b), rtol=0, atol=0)


@pytest.mark.parametrize("iters", [60, 200])
def test_admm_box_qp_matches_jax(iters):
    jc, tc = _weights(np.float64)
    qp = tmpc.condensed_qp(tc.timestep, tc.Q, tc.R, tc.Qf, 5)
    g = np.random.default_rng(iters).normal(0, 3, (E, 10))
    lo, hi = -np.ones(10), np.ones(10)
    want = jax.vmap(lambda gg: jmpc.admm_box_qp(jnp.asarray(qp.Hmat.numpy()), gg,
                                                jnp.asarray(lo), jnp.asarray(hi),
                                                iters=iters))(jnp.asarray(g))
    got = tmpc.admm_box_qp(qp.Hmat, torch.from_numpy(g), torch.from_numpy(lo),
                           torch.from_numpy(hi), iters=iters)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-10)
    # the cached factor gives the same answer as one made in the call
    again = tmpc.admm_box_qp(qp.Hmat, torch.from_numpy(g), torch.from_numpy(lo),
                             torch.from_numpy(hi), iters=iters, L=qp.L)
    assert torch.equal(got, again)
    assert np.abs(got.numpy()).max() == 1.0, "no bound is active: the box is not exercised"


def _jax_controller(paths, vx, vy, jc, total_steps, iters):
    return np.asarray(jax.vmap(
        lambda p, a, b: jmpc.mpc_controller(p, jc.desired_velocity, jc.timestep, jc.Q, jc.R,
                                            jc.Qf, total_steps=total_steps, horizon=5,
                                            current_vel_x=a, current_vel_y=b,
                                            admm_iters=iters))(
        jnp.asarray(paths), jnp.asarray(vx), jnp.asarray(vy)))


@pytest.mark.parametrize("total_steps,iters", [(10, 60), (1, 60), (10, 200), (1, 200)])
def test_controller_matches_jax(total_steps, iters):
    jc, tc = _weights(np.float64)
    paths = _paths(total_steps + iters)
    rng = np.random.default_rng(1)
    vx, vy = rng.uniform(-1, 3, E), rng.uniform(-1, 1, E)
    want = _jax_controller(paths, vx, vy, jc, total_steps, iters)
    got = tmpc.mpc_controller(torch.from_numpy(paths), tc.desired_velocity, tc.timestep, tc.Q,
                              tc.R, tc.Qf, total_steps=total_steps, horizon=5,
                              current_vel_x=torch.from_numpy(vx),
                              current_vel_y=torch.from_numpy(vy), admm_iters=iters)
    assert got.shape == (E, total_steps, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)


def test_float32_controller_matches_jax():
    jc, tc = _weights(np.float32)
    paths = _paths(3, dtype=np.float32)
    vx = np.linspace(0, 2, E).astype(np.float32)
    vy = np.zeros(E, np.float32)
    want = _jax_controller(paths, vx, vy, jc, 10, 60)
    got = tmpc.mpc_controller(torch.from_numpy(paths), tc.desired_velocity, tc.timestep, tc.Q,
                              tc.R, tc.Qf, current_vel_x=torch.from_numpy(vx),
                              current_vel_y=torch.from_numpy(vy))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_converter_matches_jax():
    rng = np.random.default_rng(2)
    ax, ay = rng.normal(0, 2, 64), rng.normal(0, 2, 64)
    speed, steer = rng.uniform(0, 5, 64), rng.uniform(-0.5, 0.5, 64)
    want = jax.vmap(lambda a, b, c, d: jmpc.mpc_converter(a, b, c, d, 0.4189, 3.0, 8.0, -4.0))(
        *map(jnp.asarray, (ax, ay, speed, steer)))
    got = tmpc.mpc_converter(*map(torch.from_numpy, (ax, ay, speed, steer)),
                             0.4189, 3.0, 8.0, -4.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
