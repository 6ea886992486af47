"""The port's gym surface: gymnasium registration and facades
(``_registration``, ``gym_adapter``, ``gym_vector``), ``gym_compat`` and the
package's ``make`` / ``make_vec``, on the CPU.  Mirrors
tests/test_gym_adapter.py, with the JAX package imported in the same
process: the port registers ``red_gym_tpu_torch/f110-v0`` and never the
plain ``f110-v0``, which stays JAX's.  The facades' observations are held
to JAX's in float64 without scan noise: each float32 value within one
float32 ulp of JAX's, the scans at the float64 bar.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

gymnasium = pytest.importorskip("gymnasium")

import red_gym_tpu  # noqa: E402,F401  (registers f110-v0)
import red_gym_tpu_torch  # noqa: E402  (registers red_gym_tpu_torch/f110-v0)
from red_gym_tpu import env as jenv  # noqa: E402
from red_gym_tpu import gym_adapter as jadapter  # noqa: E402
from red_gym_tpu_torch import assets, env as tenv, gym_adapter, gym_compat  # noqa: E402
from red_gym_tpu_torch.vec_env import VecF110Env  # noqa: E402

ENV_ID = "red_gym_tpu_torch/f110-v0"
MAP = assets.named_map_yaml("track_wide")[:-len(".yaml")]
KW = dict(map=MAP, map_ext=".png", num_agents=1, num_beams=108, timestep=0.01,
          device="cpu")
LEGACY_KEYS = ("ego_idx", "scans", "poses_x", "poses_y", "poses_theta", "linear_vels_x",
               "linear_vels_y", "ang_vels_z", "collisions", "lap_times", "lap_counts")


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def test_registration_beside_jax():
    """Both packages imported in one process: the namespaced id builds the
    port's env on the CPU, and the plain id still builds JAX's."""
    assert ENV_ID in gymnasium.registry and "f110-v0" in gymnasium.registry
    spec = gymnasium.registry[ENV_ID]
    assert spec.entry_point == "red_gym_tpu_torch.gym_adapter:F110GymnasiumEnv"
    assert spec.vector_entry_point == "red_gym_tpu_torch.gym_vector:F110VectorEnv"
    assert gymnasium.registry["f110-v0"].entry_point.startswith("red_gym_tpu.")
    env = gymnasium.make(ENV_ID, **KW)
    assert isinstance(env.unwrapped, gym_adapter.F110GymnasiumEnv)
    assert isinstance(env.unwrapped.env, tenv.F110Env)
    jax_kw = {k: v for k, v in KW.items() if k != "device"}
    assert isinstance(gymnasium.make("f110-v0", **jax_kw).unwrapped,
                      jadapter.F110GymnasiumEnv)


def test_registration_is_import_light():
    """``import red_gym_tpu_torch`` registers its id without loading the
    env, the facades or any kernel build, and registers no plain id; a
    fresh interpreter keeps this honest."""
    code = (
        "import sys, red_gym_tpu_torch\n"
        "for m in ('env', 'vec_env', 'gym_adapter', 'gym_vector', 'ops._build',\n"
        "          'red_gym_tpu'):\n"
        "    name = m if m == 'red_gym_tpu' else 'red_gym_tpu_torch.' + m\n"
        "    assert name not in sys.modules, name\n"
        "import gymnasium\n"
        "assert 'red_gym_tpu_torch/f110-v0' in gymnasium.registry\n"
        "assert 'f110-v0' not in gymnasium.registry\n"
        "print('LAZY_OK')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and "LAZY_OK" in r.stdout, r.stderr[-2000:]


def test_register_falls_back_without_vector_entry_point(monkeypatch):
    """gymnasium < 1.0 has no vector_entry_point kwarg; register() still
    registers the single-env id."""
    calls = []

    def fake_register(**kw):
        if "vector_entry_point" in kw:
            raise TypeError("unexpected keyword argument 'vector_entry_point'")
        calls.append(kw)

    monkeypatch.setattr(gymnasium, "register", fake_register)
    monkeypatch.setattr(gymnasium, "registry", {})
    gym_adapter.register()
    assert calls and calls[0]["id"] == ENV_ID
    assert "vector_entry_point" not in calls[0]


def test_gymnasium_api_roundtrip():
    env = gymnasium.make(ENV_ID, **KW)
    obs, info = env.reset(options={"poses": np.array([[0.0, 0.0, 0.0]])})
    assert env.observation_space.contains(obs), "obs outside the declared space"
    assert "checkpoint_done" in info
    obs, reward, terminated, truncated, info = env.step(np.zeros((1, 2), np.float32))
    assert isinstance(reward, float) and isinstance(terminated, bool)
    assert truncated is False
    assert obs["scans"].shape == (1, 108) and obs["scans"].dtype == np.float32
    env.close()


def test_default_poses_and_seed():
    env = gymnasium.make(ENV_ID, **KW)
    obs1, _ = env.reset(seed=7)
    obs2, _ = env.reset(seed=7)
    np.testing.assert_array_equal(obs1["scans"], obs2["scans"])
    np.testing.assert_array_equal(obs1["poses_x"],
                                  tenv.staggered_start_poses(1)[:, 0].astype(np.float32))
    env.close()


def test_action_space_bounds_match_vehicle():
    env = gymnasium.make(ENV_ID, **KW).unwrapped
    lo, hi = env.action_space.low, env.action_space.high
    assert lo.shape == (1, 2)
    np.testing.assert_allclose(lo[0], [-0.4189, -5.0], atol=1e-6)
    np.testing.assert_allclose(hi[0], [0.4189, 20.0], atol=1e-6)


def test_staggered_start_poses_equal_jax():
    for a_n in (1, 2, 5):
        np.testing.assert_array_equal(tenv.staggered_start_poses(a_n),
                                      jenv.staggered_start_poses(a_n))


@pytest.mark.parametrize("env_id", ["f110_gym:f110-v0", "f110-v0"])
def test_gym_compat_legacy_4tuple(env_id):
    """The reference main-loop contract: reset(poses) and step both return
    the classic 4-tuple with the legacy obs dict keys (reference
    examples/waypoint_follow.py:275-283)."""
    env = gym_compat.make(env_id, **KW)
    assert isinstance(env, tenv.F110Env)
    out = env.reset(np.array([[0.0, 0.0, 0.0]]))
    assert len(out) == 4
    obs, step_reward, done, info = out
    assert set(obs) == set(LEGACY_KEYS)
    obs, step_reward, done, info = env.step(np.array([[0.0, 1.0]]))
    assert isinstance(done, bool) and "checkpoint_done" in info


def test_gym_compat_unknown_id():
    with pytest.raises(ValueError):
        gym_compat.make("CartPole-v1")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_legacy_dict_types_equal_jax(dtype):
    """F110Env's legacy dict (env 0's row of the batched observation) has
    JAX's keys, dtypes and shapes."""
    poses = assets.waypoint_start_poses("track_0019", 2)
    kw = dict(map=assets.named_map_yaml("track_0019"), num_beams=54, dtype=dtype)
    jo = jenv.F110Env(**kw).reset(poses)[0]
    to = tenv.F110Env(device="cpu", **kw).reset(poses)[0]
    assert set(to) == set(jo) == set(LEGACY_KEYS)
    assert to["ego_idx"] == jo["ego_idx"] == 0
    for k in LEGACY_KEYS[1:]:
        assert isinstance(to[k], np.ndarray), k
        assert (to[k].dtype, to[k].shape) == (jo[k].dtype, jo[k].shape), k


def test_make_and_make_vec_build_the_port():
    env = red_gym_tpu_torch.make(MAP, num_agents=1, num_beams=54, device="cpu")
    assert isinstance(env, tenv.F110Env)
    vec = red_gym_tpu_torch.make_vec(MAP, 3, num_agents=1, num_beams=54, device="cpu")
    assert isinstance(vec, VecF110Env) and vec.num_envs == 3
    obs, *_ = vec.reset(np.array([[0.0, 0.0, 0.0]]))
    assert obs["scans"].shape == (3, 1, 54) and isinstance(obs["scans"], torch.Tensor)


def test_make_vec_api_roundtrip():
    envs = gymnasium.make_vec(ENV_ID, num_envs=4, **KW)
    assert envs.num_envs == 4
    assert envs.metadata["autoreset_mode"] == gymnasium.vector.AutoresetMode.SAME_STEP
    obs, info = envs.reset(seed=3)
    assert envs.observation_space.contains(obs), "obs outside the batched space"
    assert obs["scans"].shape == (4, 1, 108)
    obs, rew, term, trunc, infos = envs.step(np.zeros((4, 1, 2), np.float32))
    assert rew.shape == term.shape == trunc.shape == (4,)
    assert term.dtype == bool and not trunc.any()
    assert "final_obs" in infos and "_final_obs" in infos
    assert infos["final_obs"]["scans"].shape == (4, 1, 108)
    np.testing.assert_array_equal(infos["_final_obs"], term)
    envs.close()


def test_vector_env_reset_seed_reseeds_the_generator():
    envs = gymnasium.make_vec(ENV_ID, num_envs=2, **KW)
    act = np.tile(np.array([[0.1, 2.0]], np.float32), (2, 1, 1))
    runs = []
    for _ in range(2):
        envs.reset(seed=11)
        runs.append([envs.step(act)[0]["scans"] for _ in range(3)])
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    envs.close()


def test_vector_env_autoresets_crashed_envs():
    """Envs driven into the wall terminate and come back reset in the same
    step: the returned obs is the fresh one near the start pose, and
    final_obs carries the terminal (at-the-wall) one."""
    envs = gymnasium.make_vec(ENV_ID, num_envs=2, **KW)
    envs.reset(options={"poses": np.array([[0.0, 0.0, 0.0]])})
    act = np.tile(np.array([[0.0, 8.0]], np.float32), (2, 1, 1))
    for _ in range(300):
        obs, rew, term, trunc, infos = envs.step(act)
        if term.any():
            break
    assert term.any(), "never collided driving straight at a wall"
    e = int(np.argmax(term))
    np.testing.assert_array_equal(infos["_final_obs"], term)
    assert abs(float(obs["poses_x"][e, 0])) < 1.0
    assert float(obs["collisions"][e, 0]) == 0.0
    assert float(infos["final_obs"]["collisions"][e, 0]) == 1.0
    assert float(infos["final_obs"]["poses_x"][e, 0]) > 1.0
    envs.close()


def test_gymnasium_obs_equal_jax():
    """Reset and 10 steps of both facades in float64 without scan noise:
    every float32 observation within one float32 ulp of JAX's, the scans at
    the float64 bar, the inner float64 states within 1e-10."""
    kw = dict(KW, num_agents=2, dtype="float64", scan_noise_std=0.0)
    jax_kw = {k: v for k, v in kw.items() if k != "device"}
    t = gymnasium.make(ENV_ID, **kw)
    j = gymnasium.make("f110-v0", **jax_kw)
    poses = {"poses": tenv.staggered_start_poses(2)}
    outs = [(t.reset(options=poses)[0], j.reset(options=poses)[0])]
    act = np.array([[0.1, 3.0], [-0.05, 2.0]], np.float32)
    for _ in range(10):
        to, tr, tterm, _, _ = t.step(act)
        jo, jr, jterm, _, _ = j.step(act)
        assert (tr, tterm) == (jr, jterm)
        outs.append((to, jo))
    for to, jo in outs:
        assert set(to) == set(jo)
        for k in to:
            assert to[k].dtype == jo[k].dtype == np.float32, k
            ulp = np.spacing(np.abs(jo[k]))
            assert (np.abs(to[k] - jo[k]) <= ulp).all(), k
        err = np.abs(to["scans"].astype(np.float64) - jo["scans"].astype(np.float64))
        assert np.mean(err <= 1e-9) >= 0.999
    np.testing.assert_allclose(t.unwrapped.env.state.x[0].numpy(),
                               np.asarray(j.unwrapped.env.state.x), rtol=0, atol=1e-10)
