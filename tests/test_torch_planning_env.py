"""The port's planning env (``red_gym_tpu_torch/agents/planning_env.py``)
and bitmap rewards (``ops/bitmap_rewards.py``) against the JAX package's, on
the same numpy inputs, on the CPU (the rasterizer's and the march's twins).

The JAX env is one env vmapped over E = 4; the port's is batched.  The env
is the exact scan on the packaged track_0019 with 108 beams and no scan
noise, so neither side draws random numbers.

Bars: ``decode_action`` and ``build_path`` equal; every reward helper
equal (floats within a float32 ulp where a transcendental of each library
decides them); ``PlanningEnv`` over 10 steps in float64, both reward modes:
states (poses, velocities, the whole dynamic state) within 1e-10, bitmaps
equal, rewards within one float32 ulp, dones, paths and waypoint indices
equal; the divergence quarantine on the same injected state; a float32 run
at the exact scan's float32 bar (poses within 1e-4).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from red_gym_tpu import env as jenv
from red_gym_tpu.agents import planning_env as jpe
from red_gym_tpu.config import SimConfig as JSimConfig
from red_gym_tpu.ops import bitmap_rewards as jbr
from red_gym_tpu_torch import assets, interop
from red_gym_tpu_torch.agents import planning_env as tpe
from red_gym_tpu_torch.config import SimConfig as TSimConfig
from red_gym_tpu_torch.ops import bitmap_rewards as tbr

TRACK = "track_0019"
E, STEPS = 4, 10
CFG_KW = dict(num_agents=1, num_beams=108, timestep=0.015, scan_noise_std=0.0)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _leaves(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# decode, path, rewards
# ---------------------------------------------------------------------------


def test_decode_action_and_build_path_match_jax():
    rng = np.random.default_rng(0)
    raw = rng.uniform(-1, 1, (32, 16))
    raw[0] = 0.0                                     # a zero action: 1e-8 guard
    raw[1, 2:] = np.tile([-1.0, 0.0], 7)             # every segment reversed
    pose = np.stack([rng.uniform(-20, 20, 32), rng.uniform(-20, 20, 32),
                     rng.uniform(-np.pi, np.pi, 32)], -1)
    jc, tc = jpe.default_plan_config(jnp.float64), tpe.default_plan_config(torch.float64)
    jinc = jax.vmap(lambda a: jpe.decode_action(a, jc))(jnp.asarray(raw))
    tinc = tpe.decode_action(_t(raw), tc)
    np.testing.assert_array_equal(tinc.numpy(), np.asarray(jinc))
    jpath = jax.jit(jax.vmap(lambda i, p: jpe.build_path(i, p, jc)))(jinc, jnp.asarray(pose))
    np.testing.assert_array_equal(tpe.build_path(tinc, _t(pose), tc).numpy(), np.asarray(jpath))


@pytest.fixture(scope="module")
def bitmaps():
    """FILL-like bitmaps with walls, and car pixels inside, on walls, at the
    edges and off the canvas."""
    rng = np.random.default_rng(1)
    n, h, w = 12, 64, 64
    img = np.zeros((n, h, w), np.uint8)
    for i in range(n):
        top, bot = sorted(rng.integers(0, h, 2))
        left, right = sorted(rng.integers(0, w, 2))
        img[i, top:bot + 1, left:right + 1] = 255
        img[i, rng.integers(0, h, 20), rng.integers(0, w, 20)] = 0   # debris
    img[0] = 255
    img[1] = 0
    cx = np.concatenate([[32, 32, 0, 63, -3, 70], rng.integers(-2, 66, n - 6)])
    cy = np.concatenate([[32, 0, 63, 31, 5, 70], rng.integers(-2, 66, n - 6)])
    return img, cx.astype(np.int32), cy.astype(np.int32)


def test_bitmap_rewards_match_jax(bitmaps):
    img, cx, cy = bitmaps
    jv = lambda f: np.asarray(jax.vmap(f)(jnp.asarray(img), jnp.asarray(cx),  # noqa: E731
                                          jnp.asarray(cy)))
    ti, tx, ty = _t(img), _t(cx), _t(cy)
    np.testing.assert_array_equal(tbr.detect_collision(ti, tx, ty).numpy(),
                                  jv(jbr.detect_collision))
    np.testing.assert_array_equal(tbr.distance_from_row_center(ti, tx, ty).numpy(),
                                  jv(jbr.distance_from_row_center))
    np.testing.assert_array_equal(tbr.centerline_reward(ti, tx, ty).numpy(),
                                  jv(jbr.centerline_reward))
    np.testing.assert_array_equal(tbr.get_wall_normal(ti, tx, ty).numpy(),
                                  jv(jbr.get_wall_normal))
    gx, gy = tbr._sobel(ti)
    jg = jax.vmap(jbr._sobel)(jnp.asarray(img))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(jg[0]))
    np.testing.assert_array_equal(gy.numpy(), np.asarray(jg[1]))
    # arccos and the degree scale: each library's own float32 transcendental
    normals = tbr.get_wall_normal(ti, tx, ty)
    np.testing.assert_array_max_ulp(tbr.compute_collision_angle(normals).numpy(),
                                    np.asarray(jax.vmap(jbr.compute_collision_angle)(
                                        jnp.asarray(normals.numpy()))), maxulp=1)
    pen_t = tbr.collision_angle_penalty(ti, tx, ty).numpy()
    pen_j = jv(jbr.collision_angle_penalty)
    np.testing.assert_allclose(pen_t, pen_j, rtol=0, atol=1e-6)
    assert (pen_t < 0).any() and (pen_t == 0).any()
    assert (tbr.distance_from_row_center(ti, tx, ty) < 0).any()
    assert tbr.detect_collision(ti, tx, ty).any() and not tbr.detect_collision(ti, tx, ty).all()


# ---------------------------------------------------------------------------
# PlanningEnv against JAX
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _envs(dtype, reward_mode):
    """(JAX env, its jitted vmapped step, the port's env), built once."""
    cfg_j = JSimConfig(**CFG_KW, dtype=dtype)
    cfg_t = TSimConfig(**CFG_KW, dtype=dtype)
    jp = jenv.make_params(cfg_j, assets.named_map_yaml(TRACK))
    tp = interop.params_from_numpy(cfg_t, _leaves(jp.vehicle), _leaves(jp.tables),
                                   _leaves(jp.tmap), None, None, device="cpu")
    pdims = dict(bitmap_dims=(64, 64))
    jenv_ = jpe.PlanningEnv(cfg_j, jp, jpe.default_plan_config(cfg_j.jdtype)._replace(**pdims),
                            reward_mode=reward_mode)
    tenv_ = tpe.PlanningEnv(cfg_t, tp, tpe.default_plan_config(cfg_t.tdtype)._replace(**pdims),
                            reward_mode=reward_mode, device="cpu")
    return jenv_, jax.jit(jax.vmap(jenv_.step)), tenv_


def _poses(dtype):
    """Env 0 on the start, env 1 turned toward the wall, env 2 behind the
    start, env 3 off the map's origin corner."""
    p = np.tile(assets.waypoint_start_poses(TRACK, 1)[None], (E, 1, 1))
    p[1, 0, 2] += 1.4
    p[2, 0, :2] -= 0.6 * np.array([np.cos(p[2, 0, 2]), np.sin(p[2, 0, 2])])
    p[3, 0, 2] -= 0.7
    return p.astype(dtype)


def _actions(dtype, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (STEPS, E, 16)).astype(dtype)


def _run(dtype, reward_mode, steps=STEPS):
    """Reset + ``steps`` steps of both envs -> a list of (jax, port)
    records, each the plan state and the step's outputs as numpy."""
    jenv_, jstep, tenv_ = _envs(dtype, reward_mode)
    poses, acts = _poses(dtype), _actions(dtype)
    jps = jax.vmap(jenv_.reset)(jnp.asarray(poses), jax.random.split(jax.random.PRNGKey(0), E))
    gen = torch.Generator().manual_seed(0)
    tps = tenv_.reset(_t(poses), gen)
    recs = [(_record(jps), _record(tps))]
    for i in range(steps):
        jps, _, jr, jd, _ = jstep(jps, jnp.asarray(acts[i]))
        tps, tb, tr, td, _ = tenv_.step(tps, _t(acts[i]), gen)
        assert torch.equal(tb, tps.bitmap)
        recs.append((dict(_record(jps), reward=np.asarray(jr), done=np.asarray(jd)),
                     dict(_record(tps), reward=tr.numpy(), done=td.numpy())))
    return recs


def _record(ps):
    return {"x": np.asarray(ps.env_state.x), "bitmap": np.asarray(ps.bitmap),
            "path": np.asarray(ps.path), "sub_index": np.asarray(ps.sub_index),
            "prev_pos": np.asarray(ps.prev_pos), "scans": np.asarray(ps.obs.scans)}


@pytest.fixture(scope="module", params=["sal", "fixed"])
def f64_run(request):
    return request.param, _run("float64", request.param)


def test_planning_env_float64_matches_jax(f64_run):
    mode, recs = f64_run
    for i, (j, t) in enumerate(recs):
        msg = f"{mode} step {i}"
        np.testing.assert_allclose(t["x"], j["x"], rtol=0, atol=1e-10, err_msg=msg)
        np.testing.assert_allclose(t["prev_pos"], j["prev_pos"], rtol=0, atol=1e-10, err_msg=msg)
        np.testing.assert_array_equal(t["bitmap"], j["bitmap"], err_msg=msg)
        np.testing.assert_array_equal(t["path"], j["path"], err_msg=msg)
        np.testing.assert_array_equal(t["sub_index"], j["sub_index"], err_msg=msg)
        if i:
            assert t["reward"].dtype == np.float32
            np.testing.assert_array_max_ulp(t["reward"], j["reward"], maxulp=1)
            np.testing.assert_array_equal(t["done"], j["done"], err_msg=msg)


def test_planning_env_run_is_not_trivial(f64_run):
    """The fixture's cars move off their start (0.15 s from rest) and their
    rewards vary."""
    mode, recs = f64_run
    moved = np.abs(recs[-1][1]["x"][:, 0, :2] - recs[0][1]["x"][:, 0, :2]).max()
    assert moved > 0.02
    rewards = np.stack([t["reward"] for _, t in recs[1:]])
    assert np.unique(rewards).size > 4


def test_planning_env_float32_at_the_exact_scan_bar():
    recs = _run("float32", "fixed", steps=5)
    for i, (j, t) in enumerate(recs):
        np.testing.assert_allclose(t["x"], j["x"], rtol=0, atol=1e-4, err_msg=f"step {i}")
        err = np.abs(t["scans"].astype(np.float64) - j["scans"])
        assert np.quantile(err, 0.99) < 1e-3
        # a bitmap pixel follows its endpoint's rounding: within a few pixels
        assert np.mean(t["bitmap"] != j["bitmap"]) < 2e-3
        if i:
            np.testing.assert_array_equal(t["done"], j["done"])
            np.testing.assert_allclose(t["reward"], j["reward"], rtol=0, atol=1e-3)


def test_divergence_quarantine_matches_jax():
    """A huge yaw rate (the stiff model's pre-NaN stage) in env 1 and a NaN
    in env 3 flag those envs done with the crash reward, in both."""
    jenv_, jstep, tenv_ = _envs("float64", "fixed")
    poses = _poses(np.float64)
    jps = jax.vmap(jenv_.reset)(jnp.asarray(poses), jax.random.split(jax.random.PRNGKey(0), E))
    tps = tenv_.reset(_t(poses), torch.Generator().manual_seed(0))
    x = np.asarray(jps.env_state.x).copy()
    x[1, 0, 5] = 1e35
    x[3, 0, 6] = np.nan
    jps = jps._replace(env_state=jps.env_state._replace(x=jnp.asarray(x)))
    tps = tps._replace(env_state=tps.env_state._replace(x=_t(x)))
    act = _actions(np.float64)[0]
    _, _, jr, jd, _ = jstep(jps, jnp.asarray(act))
    _, _, tr, td, _ = tenv_.step(tps, _t(act), torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert td[1] and td[3]
    np.testing.assert_array_equal(tr.numpy()[[1, 3]], [-100.0, -100.0])
    np.testing.assert_array_max_ulp(tr.numpy(), np.asarray(jr), maxulp=1)


def test_reset_done_restarts_only_the_done_envs():
    """The done envs equal a fresh reset of them (as JAX's reset-all and
    select), the others keep their plan state."""
    *_, tenv_ = _envs("float64", "fixed")
    poses = _t(_poses(np.float64))
    gen = torch.Generator().manual_seed(0)
    ps0 = tenv_.reset(poses, gen)
    ps, *_ = tenv_.step(ps0, _t(_actions(np.float64)[0]), gen)
    done = torch.tensor([False, True, False, True])
    got, any_ = tenv_.reset_done(ps, done, gen)
    assert any_
    for name in ("bitmap", "path", "sub_index", "prev_pos"):
        a, b, f = getattr(got, name), getattr(ps, name), getattr(ps0, name)
        assert torch.equal(a[~done], b[~done]) and torch.equal(a[done], f[done]), name
    for a, b, f in zip(got.env_state, ps.env_state, ps0.env_state):
        if a is not None:
            assert torch.equal(a[~done], b[~done]) and torch.equal(a[done], f[done])
    same, any_ = tenv_.reset_done(ps, torch.zeros(E, dtype=torch.bool), gen)
    assert same is ps and not any_


def test_env_params_on_another_device_are_refused():
    cfg = TSimConfig(**CFG_KW)
    *_, tenv_ = _envs("float32", "fixed")
    with pytest.raises(ValueError, match="env_params are on cpu"):
        tpe.PlanningEnv(cfg, tenv_.env_params, device="meta")
