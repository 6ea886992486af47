"""The port's CMA-ES parameter search against the JAX package's.

``CMAES`` is the same numpy code: ask/tell BIT-equal over 30 generations on
JAX's quadratic (tests/test_param_search.py:19-27) and in its bounds case.
The lap-time evaluator and ``search`` run on track_0019 (the reference's
example map is not packaged; JAX's own tests of them need a reference
checkout) in the float64 exact scan with 32 beams and ``march_iters`` 24,
from the track's first waypoint: fitness within 1e-9 of JAX's for JAX's
four candidates over 250 steps, with the final state, scans, crash flags,
toggles and lap times of the race against JAX's, and ``search`` at popsize 4, 2 generations,
120 steps: the best dict and the best fitness within 1e-9.  One env step
with (P, 1) vehicle leaves, each env its own car, equals JAX's vmapped step
within 1e-10 (float64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from red_gym_tpu import env as jenv
from red_gym_tpu.agents import pure_pursuit as jpp
from red_gym_tpu.config import SimConfig as JSimConfig, VehicleParams as JVehicle
from red_gym_tpu.tuning import param_search as jps
from red_gym_tpu_torch import assets, env as tenv
from red_gym_tpu_torch.agents import pure_pursuit as tpp
from red_gym_tpu_torch.config import SimConfig as TSimConfig
from red_gym_tpu_torch.tuning import param_search as tps

TRACK = "track_0019"
CFG_KW = dict(num_agents=1, num_beams=32, dtype="float64", march_iters=24,
              scan_noise_std=0.0)
POP = {"m": [3.74] * 4, "lf": [0.15875] * 4,
       "tlad": [0.82, 0.82, 0.82, 0.05],        # last: hopeless lookahead
       "vgain": [1.0, 1.375, 0.7, 1.375]}


def _run_pair(make, steps=60):
    es_j, es_t = make(jps.CMAES), make(tps.CMAES)
    target = np.array([0.3, -1.2, 2.0])
    for _ in range(steps):
        xs_j, xs_t = es_j.ask(), es_t.ask()
        np.testing.assert_array_equal(xs_t, xs_j)
        fs = np.sum((xs_j - target) ** 2, axis=1)
        es_j.tell(xs_j, fs)
        es_t.tell(xs_t, fs)
        np.testing.assert_array_equal(es_t.m, es_j.m)
        np.testing.assert_array_equal(es_t.C, es_j.C)
        assert es_t.sigma == es_j.sigma
    assert es_t.best_f == es_j.best_f
    np.testing.assert_array_equal(es_t.best_x, es_j.best_x)
    return es_t


def test_cmaes_bit_equal_on_the_quadratic():
    es = _run_pair(lambda cls: cls(x0=np.zeros(3), sigma0=1.0, popsize=16, seed=1), 30)
    assert es.gen == 30


def test_cmaes_bit_equal_with_bounds():
    bounds = np.array([[0.0, 1.0], [2.0, 3.0], [-5.0, 5.0]])
    es = _run_pair(lambda cls: cls(x0=[0.5, 2.5, 0.0], sigma0=5.0, popsize=32, seed=2,
                                   bounds=bounds), 10)
    xs = es.ask()
    assert np.all((xs >= bounds[:, 0]) & (xs <= bounds[:, 1]))


def test_cmaes_minimizes_quadratic():
    target = np.array([0.3, -1.2, 2.0])
    es = tps.CMAES(x0=np.zeros(3), sigma0=1.0, popsize=16, seed=1)
    for _ in range(60):
        xs = es.ask()
        es.tell(xs, np.sum((xs - target) ** 2, axis=1))
    assert es.best_f < 1e-4
    np.testing.assert_allclose(es.best_x, target, atol=0.02)


def _inputs():
    yml, csv = assets.named_map_yaml(TRACK), assets.waypoints_csv(TRACK)
    start = assets.waypoint_start_poses(TRACK, 1)[0]
    return yml, csv, start


def _jax_rollout(cfg, yml, waypoints, steps, start, pop):
    """JAX's evaluator's race (tuning/param_search.py:141-186), vmapped
    reset, step and plan under one jitted scan, returning what its fitness
    is taken from: (final state, final observation, crashed)."""
    p_n = len(next(iter(pop.values())))
    params0 = jenv.make_params(cfg, yml)
    veh = JVehicle(*[jnp.broadcast_to(jnp.asarray(pop.get(f, getattr(params0.vehicle, f)),
                                                  jnp.float64), (p_n,))
                     for f in JVehicle._fields])
    env_params = params0._replace(vehicle=veh)
    ppp = jpp.make_params(waypoints)
    ppp = ppp._replace(tlad=jnp.asarray(pop["tlad"], jnp.float64),
                       vgain=jnp.asarray(pop["vgain"], jnp.float64),
                       wheelbase=veh.lf + veh.lr)
    par_ax = jenv.EnvParams(vehicle=JVehicle(*([0] * len(JVehicle._fields))), tables=None,
                            tmap=None, rtex=None)
    ppp_ax = ppp.__class__(waypoints=None, tlad=0, vgain=0, wheelbase=0, max_reacquire=None)
    reset_v = jax.vmap(lambda pr, po, k: jenv.reset(cfg, pr, po, k), in_axes=(par_ax, 0, 0))
    step_v = jax.vmap(lambda pr, s, a: jenv.step(cfg, pr, s, a), in_axes=(par_ax, 0, 0))
    plan_v = jax.vmap(jpp.plan, in_axes=(0, 0, 0, ppp_ax))

    def body(carry, _):
        state, obs, crashed = carry
        speed, steer = plan_v(obs.poses_x[:, 0], obs.poses_y[:, 0], obs.poses_theta[:, 0], ppp)
        state, obs, *_ = step_v(env_params, state, jnp.stack([steer, speed], -1)[:, None, :])
        return (state, obs, crashed | (obs.collisions[:, 0] > 0)), None

    poses = jnp.broadcast_to(jnp.asarray(start, jnp.float64).reshape(1, 3), (p_n, 1, 3))
    state, obs, *_ = reset_v(env_params, poses, jax.random.split(jax.random.PRNGKey(0), p_n))
    carry = (state, obs, obs.collisions[:, 0] > 0)
    return jax.jit(lambda c: jax.lax.scan(body, c, None, length=steps)[0])(carry)


def test_evaluator_matches_jax():
    """Fitness within 1e-9 of JAX's evaluator, and, since 250 steps (2.5 s)
    finish no lap and each fitness is the budget plus a penalty, the race
    it is taken from too: the final state, scans, crash flags, toggles and
    lap times against JAX's race (float64: 1e-9, flags and counts equal)."""
    torch.set_num_threads(2)
    yml, csv, start = _inputs()
    jw = jpp.load_waypoints_csv(csv, dtype=jnp.float64)
    jf = np.asarray(jps.make_laptime_evaluator(JSimConfig(**CFG_KW), yml, jw, 250, start)(
        {k: jnp.asarray(v) for k, v in POP.items()}))
    ev = tps.make_laptime_evaluator(
        TSimConfig(**CFG_KW), yml, tpp.load_waypoints_csv(csv, device="cpu"), 250, start,
        device="cpu")
    tf = ev({k: np.asarray(v) for k, v in POP.items()})
    assert tf.shape == (4,) and tf.dtype == torch.float64
    # float64 bar: 1e-9
    np.testing.assert_allclose(tf.numpy(), jf, rtol=0, atol=1e-9)
    assert np.all(np.isfinite(jf)) and tf[3] >= tf.min()

    ts, to, tc = ev.rollout({k: np.asarray(v) for k, v in POP.items()})
    assert torch.equal(ev.fitness(ts, tc), tf)
    js, jo, jc = _jax_rollout(JSimConfig(**CFG_KW), yml, jw, 250, start, POP)
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=0, atol=1e-9)
    np.testing.assert_allclose(to.scans.numpy(), np.asarray(jo.scans), rtol=0, atol=1e-9)
    np.testing.assert_allclose(ts.lap_times.numpy(), np.asarray(js.lap_times), rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(ts.toggle_list.numpy(), np.asarray(js.toggle_list))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    # the four races end apart: the comparison is not of one repeated value
    assert len({round(float(v), 6) for v in ts.x[:, 0, 0]}) == 4


def test_search_matches_jax():
    torch.set_num_threads(2)
    yml, csv, start = _inputs()
    kw = dict(start_pose=start, popsize=4, generations=2, steps=120, log=None)
    jbest, jf = jps.search(JSimConfig(**CFG_KW), yml,
                           jpp.load_waypoints_csv(csv, dtype=jnp.float64), **kw)
    logs = []
    tbest, tf = tps.search(TSimConfig(**CFG_KW), yml, tpp.load_waypoints_csv(csv, device="cpu"),
                           **{**kw, "log": logs.append}, device="cpu")
    assert set(tbest) == {"m", "lf", "tlad", "vgain"}
    for k in jbest:
        np.testing.assert_allclose(tbest[k], jbest[k], rtol=0, atol=1e-9)
    np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-9)
    assert len(logs) == 2 and logs[0].startswith("gen 0: best ") and "sigma" in logs[0]


def test_per_env_vehicle_step_matches_jax():
    """Reset and 5 steps of 4 envs, each env with its own car (P, 1)
    leaves here, vmapped (P,) leaves in JAX), float64 within 1e-10."""
    torch.set_num_threads(2)
    yml, csv, start = _inputs()
    cfg_j, cfg_t = JSimConfig(**CFG_KW), TSimConfig(**CFG_KW)
    pop = {"m": np.array([3.0, 3.5, 3.9, 3.74]), "lf": np.array([0.147, 0.15, 0.16, 0.17]),
           "tlad": np.array([0.5, 1.0, 2.0, 3.0]), "vgain": np.array([0.6, 0.9, 1.2, 1.4])}
    jp0 = jenv.make_params(cfg_j, yml)
    veh = JVehicle(*[jnp.broadcast_to(jnp.asarray(pop.get(f, getattr(jp0.vehicle, f)),
                                                  jnp.float64), (4,))
                     for f in JVehicle._fields])
    jp = jp0._replace(vehicle=veh)
    par_ax = jenv.EnvParams(vehicle=JVehicle(*([0] * len(JVehicle._fields))), tables=None,
                            tmap=None, rtex=None)
    reset_v = jax.vmap(lambda pr, po, k: jenv.reset(cfg_j, pr, po, k), in_axes=(par_ax, 0, 0))
    step_v = jax.jit(jax.vmap(lambda pr, s, a: jenv.step(cfg_j, pr, s, a),
                              in_axes=(par_ax, 0, 0)))
    poses = np.broadcast_to(start, (4, 1, 3)).copy()
    js, jo, *_ = reset_v(jp, jnp.asarray(poses), jax.random.split(jax.random.PRNGKey(0), 4))

    tp0 = tenv.make_params(cfg_t, yml, device="cpu")
    tp, ppp = tps.population_params(cfg_t, tp0, tpp.load_waypoints_csv(csv, device="cpu"), pop)
    assert tp.vehicle.m.shape == (4, 1) and ppp.wheelbase.shape == (4,)
    gen = torch.Generator().manual_seed(0)
    ts, to, *_ = tenv.reset(cfg_t, tp, torch.from_numpy(poses), gen)
    rng = np.random.default_rng(5)
    for _ in range(5):
        act = np.stack([rng.uniform(-0.4, 0.4, (4, 1)), rng.uniform(2.0, 8.0, (4, 1))], -1)
        js, jo, *_ = step_v(jp, js, jnp.asarray(act))
        ts, to, *_ = tenv.step(cfg_t, tp, ts, torch.from_numpy(act), gen)
        np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=0, atol=1e-10)
        np.testing.assert_allclose(to.scans.numpy(), np.asarray(jo.scans), rtol=0, atol=1e-9)
    # the cars differ, so their states do
    assert len({round(float(v), 9) for v in ts.x[:, 0, 3]}) > 1
