"""The port's stacked-state dynamics and integrators, ``get_range`` and
``blocked_view_mask`` against JAX.

Fuzzed float64 inputs made with numpy go through both packages.  Bar: 1e-12
(the jit-vs-eager bar of docs/parity.md); masks exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from red_gym_tpu import config as jcfg
from red_gym_tpu.config import SimConfig as JSimConfig
from red_gym_tpu.ops import agent_scan as jas, collision as jcol, dynamics as jdyn
from red_gym_tpu.ops import integrate as jint, scan as jscan
from red_gym_tpu_torch import config as tcfg
from red_gym_tpu_torch.config import SimConfig as TSimConfig
from red_gym_tpu_torch.ops import agent_scan as tas, collision as tcol, dynamics as tdyn
from red_gym_tpu_torch.ops import integrate as tint, scan as tscan

TOL = dict(rtol=1e-12, atol=1e-12)
N = 2048


def _state(rng, n=N):
    """(n, 7) states; a quarter in the |v| < 0.5 kinematic branch, some
    steering beyond the limits."""
    x = np.stack([rng.uniform(-50, 50, n), rng.uniform(-50, 50, n),
                  rng.uniform(-0.5, 0.5, n), rng.uniform(-6.0, 21.0, n),
                  rng.uniform(-7, 7, n), rng.uniform(-3, 3, n),
                  rng.uniform(-0.3, 0.3, n)], axis=-1)
    x[: n // 4, 3] = rng.uniform(-0.5, 0.5, n // 4)
    return x


def _controls(rng, n=N):
    return np.stack([rng.uniform(-4, 4, n), rng.uniform(-12, 12, n)], axis=-1)


def _params():
    d = jcfg.DEFAULT_PARAMS_DICT
    return (jcfg.VehicleParams(**{k: jnp.asarray(v, jnp.float64) for k, v in d.items()}),
            tcfg.VehicleParams.default(torch.float64, device="cpu"))


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_constrain_inputs_matches(seed):
    rng = np.random.default_rng(seed)
    x, u = _state(rng), _controls(rng)
    x[:64, 2] = 0.4192                      # steering at s_max
    jp, tp = _params()
    _close(tdyn.constrain_inputs(torch.from_numpy(x), torch.from_numpy(u), tp),
           jdyn.constrain_inputs(jnp.asarray(x), jnp.asarray(u), jp))


@pytest.mark.parametrize("seed", [0, 1])
def test_vehicle_dynamics_ks_and_st_match(seed):
    rng = np.random.default_rng(10 + seed)
    x, u = _state(rng), _controls(rng)
    jp, tp = _params()
    _close(tdyn.vehicle_dynamics_ks(torch.from_numpy(x[:, :5]), torch.from_numpy(u), tp),
           jdyn.vehicle_dynamics_ks(jnp.asarray(x[:, :5]), jnp.asarray(u), jp))
    _close(tdyn.vehicle_dynamics_st(torch.from_numpy(x), torch.from_numpy(u), tp),
           jdyn.vehicle_dynamics_st(jnp.asarray(x), jnp.asarray(u), jp))


@pytest.mark.parametrize("integrator", ["RK4", "EULER"])
def test_integrate_stacked_matches(integrator):
    """``integrate`` and the step it names, on a (E, A, 7) state over ten
    steps of the dynamic single-track RHS with constrained inputs."""
    rng = np.random.default_rng(3)
    x = _state(rng, 256).reshape(64, 4, 7)
    u = _controls(rng, 256).reshape(64, 4, 2)
    jp, tp = _params()
    ji, ti = getattr(jcfg.Integrator, integrator), getattr(tcfg.Integrator, integrator)
    jstep = {"RK4": jint.rk4_step, "EULER": jint.euler_step}[integrator]
    tstep = {"RK4": tint.rk4_step, "EULER": tint.euler_step}[integrator]
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for _ in range(10):
        jx = jint.integrate(ji, jdyn.vehicle_dynamics_st, jx, jnp.asarray(u), 0.01, jp)
        tx = tint.integrate(ti, tdyn.vehicle_dynamics_st, tx, torch.from_numpy(u), 0.01, tp)
        _close(tx, jx)
    _close(tstep(tdyn.vehicle_dynamics_st, tx, torch.from_numpy(u), 0.02, tp),
           jstep(jdyn.vehicle_dynamics_st, jx, jnp.asarray(u), 0.02, jp))


def test_integrate_unknown_raises():
    with pytest.raises(ValueError, match="unknown integrator"):
        tint.integrate("midpoint", tdyn.vehicle_dynamics_st,
                       torch.zeros(1, 7, dtype=torch.float64),
                       torch.zeros(1, 2, dtype=torch.float64), 0.01,
                       _params()[1])


def test_get_range_matches_with_collinear_fallback():
    rng = np.random.default_rng(4)
    n = 4096
    pose = np.concatenate([rng.uniform(-5, 5, (n, 2)), rng.uniform(-4, 4, (n, 1))], -1)
    va, vb = rng.uniform(-5, 5, (n, 2)), rng.uniform(-5, 5, (n, 2))
    theta = rng.uniform(-np.pi, np.pi, n)
    # beams along the segment's own line: the collinear branch (the
    # denominator is exactly 0 for a beam at -pi/2 and a segment on the y
    # axis through the pose)
    k = 256
    pose[:k, :2] = 0.0
    va[:k] = np.stack([np.zeros(k), rng.uniform(-3, -1, k)], -1)
    vb[:k] = np.stack([np.zeros(k), rng.uniform(-6, -4, k)], -1)
    theta[:k] = -np.pi / 2
    args = (pose, theta, va, vb)
    j = np.asarray(jas.get_range(*map(jnp.asarray, args)))
    t = tas.get_range(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_array_equal(np.isinf(t), np.isinf(j))
    fin = np.isfinite(j)
    np.testing.assert_allclose(t[fin], j[fin], **TOL)
    assert np.isfinite(j[:k]).all(), "the collinear rows should hit"
    assert 0.1 < np.isinf(j[k:]).mean() < 0.9, "fixture needs hits and misses"


def test_blocked_view_mask_matches():
    rng = np.random.default_rng(5)
    kw = dict(num_beams=270, dtype="float64")
    jt = jscan.build_tables(JSimConfig(**kw), 0.31, 0.58)
    tt = tscan.build_tables(TSimConfig(**kw), 0.31, 0.58, device="cpu")
    n = 512
    pose = np.concatenate([rng.uniform(-3, 3, (n, 2)), rng.uniform(-7, 7, (n, 1))], -1)
    opp = np.concatenate([rng.uniform(-3, 3, (n, 2)), rng.uniform(-7, 7, (n, 1))], -1)
    jv = jcol.get_vertices(jnp.asarray(opp), 0.58, 0.31)
    tv = tcol.get_vertices(torch.from_numpy(opp), 0.58, 0.31)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    j = np.asarray(jas.blocked_view_mask(jnp.asarray(pose), jv, jt))
    t = tas.blocked_view_mask(torch.from_numpy(pose), tv, tt).numpy()
    np.testing.assert_array_equal(t, j)
    assert 0.0 < t.mean() < 1.0
