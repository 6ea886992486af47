"""The port's vehicle dynamics, integrators and body collision against JAX.

Fuzzed float64 inputs made with numpy go through both packages.  Bar: 1e-12
(the jit-vs-eager bar of docs/parity.md); collision booleans exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from red_gym_tpu import config as jcfg
from red_gym_tpu.ops import collision as jcol, dynamics as jdyn, integrate as jint
from red_gym_tpu_torch import config as tcfg
from red_gym_tpu_torch.ops import collision as tcol, dynamics as tdyn, integrate as tint

TOL = dict(rtol=1e-12, atol=1e-12)
N = 4096


def _state(rng, n=N):
    """Random 7-component states; a quarter of them in the |v| < 0.5
    kinematic branch, some steering against the limits."""
    vel = rng.uniform(-6.0, 21.0, n)
    vel[: n // 4] = rng.uniform(-0.5, 0.5, n // 4)
    return [rng.uniform(-50, 50, n), rng.uniform(-50, 50, n),
            rng.uniform(-0.5, 0.5, n), vel, rng.uniform(-7, 7, n),
            rng.uniform(-3, 3, n), rng.uniform(-0.3, 0.3, n)]


def _params():
    d = jcfg.DEFAULT_PARAMS_DICT
    return (jcfg.VehicleParams(**{k: jnp.asarray(v, jnp.float64) for k, v in d.items()}),
            tcfg.VehicleParams.default(torch.float64))


def _close(t_vals, j_vals):
    for t, j in zip(t_vals, j_vals):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_vehicle_dynamics_st_matches(seed):
    rng = np.random.default_rng(seed)
    xs = _state(rng)
    sv, ac = rng.uniform(-4, 4, N), rng.uniform(-12, 12, N)
    jp, tp = _params()
    j = jdyn.vehicle_dynamics_st_t(tuple(jnp.asarray(x) for x in xs),
                                   jnp.asarray(sv), jnp.asarray(ac), jp)
    t = tdyn.vehicle_dynamics_st_t(tuple(torch.from_numpy(x) for x in xs),
                                   torch.from_numpy(sv), torch.from_numpy(ac), tp)
    _close(t, j)


def test_pid_matches():
    rng = np.random.default_rng(2)
    args = [rng.uniform(-6, 21, N), rng.uniform(-0.5, 0.5, N),
            rng.uniform(-6, 21, N), rng.uniform(-0.5, 0.5, N)]
    args[1][:64] = args[3][:64]          # the |steer_diff| <= 1e-4 branch
    jp, tp = _params()
    j = jdyn.pid(*[jnp.asarray(a) for a in args], jp.sv_max, jp.a_max,
                 jp.v_max, jp.v_min)
    t = tdyn.pid(*[torch.from_numpy(a) for a in args], tp.sv_max, tp.a_max,
                 tp.v_max, tp.v_min)
    _close(t, j)


@pytest.mark.parametrize("integrator", ["RK4", "EULER"])
def test_integrate_and_wrap_yaw_match(integrator):
    rng = np.random.default_rng(3)
    xs = _state(rng)
    sv, ac = rng.uniform(-4, 4, N), rng.uniform(-12, 12, N)
    jp, tp = _params()
    j = jint.integrate_t(jcfg.Integrator[integrator], jdyn.vehicle_dynamics_st_t,
                         tuple(jnp.asarray(x) for x in xs), jnp.asarray(sv),
                         jnp.asarray(ac), 0.01, jp)
    t = tint.integrate_t(tcfg.Integrator[integrator], tdyn.vehicle_dynamics_st_t,
                         tuple(torch.from_numpy(x) for x in xs),
                         torch.from_numpy(sv), torch.from_numpy(ac), 0.01, tp)
    _close(t, j)
    yaw = rng.uniform(-7.0, 14.0, N)
    np.testing.assert_array_equal(tint.wrap_yaw(torch.from_numpy(yaw)).numpy(),
                                  np.asarray(jint.wrap_yaw(jnp.asarray(yaw))))


@pytest.mark.parametrize("num_agents", [2, 3, 4, 5])
def test_pairwise_hits_and_vertices_match(num_agents):
    rng = np.random.default_rng(10 + num_agents)
    e_n = 2048
    # cars within ~1 m of each other: a mix of overlaps and near misses
    poses = np.concatenate([rng.uniform(-0.6, 0.6, (e_n, num_agents, 2)),
                            rng.uniform(0, 2 * np.pi, (e_n, num_agents, 1))], -1)
    length, width = 0.58, 0.31
    j = jax.vmap(lambda p: jcol.pairwise_hits_from_poses(p, length, width))(
        jnp.asarray(poses))
    t = tcol.pairwise_hits_from_poses(torch.from_numpy(poses), length, width).numpy()
    np.testing.assert_array_equal(t, np.asarray(j))
    assert 0.05 < t.mean() < 0.95, "fixture needs both hits and misses"
    # every pair against the general quad SAT of the JAX package
    verts_t = tcol.get_vertices(torch.from_numpy(poses), length, width)
    verts_j = jcol.get_vertices(jnp.asarray(poses), length, width)
    np.testing.assert_allclose(verts_t.numpy(), np.asarray(verts_j), **TOL)
    coll, _ = jcol.collision_multiple(verts_j)
    np.testing.assert_array_equal(t, np.asarray(coll) > 0)
