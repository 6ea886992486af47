"""The PyTorch port's env step, as a whole, against the JAX package.

JAX runs ``env.reset`` + 30 vmapped ``env.step`` calls with its scan
megakernel (interpret mode on the CPU); the port runs
``rollout.batched_reset`` / ``batched_step`` on the identical texture,
tables and vehicle (carried across by ``interop.params_from_numpy``), from
waypoint starts on track_0019 at texture stride 8, with the same numpy
actions.  Both noise pools are one identical numpy pool whose rows are all
equal, so each package's own row pick cannot matter.

Bars: poses within 1e-4 m; scans at the float32 bar of
tests/test_scan_fast.py (p99 |diff| < 1e-3 m, < 0.2 % of beams off by more
than 4 texture cells); collisions, lap counts and done exactly equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from red_gym_tpu import env as jenv
from red_gym_tpu import rollout as jrollout
from red_gym_tpu.config import SimConfig as JSimConfig
from red_gym_tpu_torch import assets, env as tenv, interop, rollout as trollout
from red_gym_tpu_torch.config import SimConfig as TSimConfig

E, A, B = 160, 2, 270
STEPS = 30
TRACK = "track_0019"
CFG_KW = dict(num_agents=A, num_beams=B, dtype="float32", scan_mode="fast",
              rt_pose_stride=8, scan_backend="pallas", fuse_scan_ttc="on",
              scan_megakernel="on", fuse_scan_opp="off",
              rt_ew_dtype="float32", ttc_thresh=2.0)


def _leaves(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items() if v is not None}


def _scan_bar(a, b, cell):
    err = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    assert np.quantile(err, 0.99) < 1e-3, np.quantile(err, 0.99)
    assert np.mean(err > 4 * cell) < 2e-3, np.mean(err > 4 * cell)


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RED_GYM_TPU_TEXTURE_CACHE", "off")
        cfg_j = JSimConfig(**CFG_KW)
        jp = jenv.make_params(cfg_j, assets.named_map_yaml(TRACK))
    rng = np.random.default_rng(0)
    row = rng.normal(0.0, 0.01, (1, B)).astype(np.float32)
    pool = np.repeat(row, cfg_j.noise_pool_rows, axis=0)
    jp = jp._replace(noise_pool=jnp.asarray(pool).astype(jnp.bfloat16))

    cfg_t = TSimConfig(**CFG_KW)
    tp = interop.params_from_numpy(
        cfg_t, _leaves(jp.vehicle), _leaves(jp.tables), _leaves(jp.tmap),
        _leaves(jp.rtex), np.asarray(jp.noise_pool))
    poses = np.tile(assets.waypoint_start_poses(TRACK, A)[None], (E, 1, 1))
    actions = np.stack([rng.uniform(-0.4, 0.4, (STEPS + 1, E, A)),
                        rng.uniform(1.0, 8.0, (STEPS + 1, E, A))],
                       axis=-1).astype(np.float32)
    return cfg_j, jp, cfg_t, tp, poses.astype(np.float32), actions


def _jax_step(cfg_j, jp):
    return jax.jit(jax.vmap(lambda s, a: jenv.step(cfg_j, jp, s, a)))


def test_step_sequence_matches_jax(setup):
    cfg_j, jp, cfg_t, tp, poses, actions = setup
    cell = float(tp.rtex.cell)
    keys = jax.random.split(jax.random.PRNGKey(0), E)
    js, jo, _, jd, _ = jrollout.batched_reset(cfg_j, jp, jnp.asarray(poses), keys)
    gen = torch.Generator().manual_seed(0)
    ts, to, _, td, _ = trollout.batched_reset(cfg_t, tp, torch.from_numpy(poses), gen)
    step_j = _jax_step(cfg_j, jp)
    n_coll = 0
    for i in range(STEPS + 1):
        if i:
            js, jo, _, jd, _ = step_j(js, jnp.asarray(actions[i]))
            ts, to, _, td, _ = trollout.batched_step(
                cfg_t, tp, ts, torch.from_numpy(actions[i]), gen)
        jx = np.asarray(js.x)
        np.testing.assert_allclose(ts.x[..., [0, 1, 4]].numpy(),
                                   jx[..., [0, 1, 4]], rtol=0, atol=1e-4)
        _scan_bar(to.scans.numpy(), jo.scans, cell)
        np.testing.assert_array_equal(ts.collisions.numpy(), np.asarray(js.collisions))
        np.testing.assert_array_equal(ts.lap_counts.numpy(), np.asarray(js.lap_counts))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        n_coll += int(np.asarray(js.collisions).sum())
    # fixture guard: the iTTC freeze path must actually run
    assert n_coll > 0, "no collisions in the fixture"


def test_rollout_auto_reset_step_matches_jax(setup):
    """One make_rollout step with auto-reset, from one identical state."""
    cfg_j, jp, cfg_t, tp, poses, actions = setup
    keys = jax.random.split(jax.random.PRNGKey(1), E)
    js, jo, *_ = jrollout.batched_reset(cfg_j, jp, jnp.asarray(poses), keys)
    step_j = _jax_step(cfg_j, jp)
    for i in range(1, STEPS + 1):
        js, jo, _, jd, _ = step_j(js, jnp.asarray(actions[i]))

    act = actions[0]
    run_j = jrollout.make_rollout(cfg_j, jp, lambda obs, key: jnp.asarray(act), 1)
    (js2, jo2, _), (_, jdone) = run_j(jrollout.RolloutCarry(js, jo, jax.random.PRNGKey(2)))
    jdone = np.asarray(jdone)[0]
    assert jdone.any() and not jdone.all(), "fixture needs some envs done"

    state = interop.state_from_numpy(_leaves(js))
    obs = tenv.Observation(*[interop.to_tensor(np.asarray(v)) for v in jo])
    run_t = trollout.make_rollout(cfg_t, tp, lambda obs, gen: torch.from_numpy(act), 1)
    (ts2, to2), outs = run_t(trollout.RolloutCarry(state, obs), torch.Generator())
    np.testing.assert_array_equal(outs["done"][0].numpy(), jdone)
    assert outs["resets"] == 1
    np.testing.assert_allclose(ts2.x.numpy(), np.asarray(js2.x), rtol=0, atol=1e-4)
    _scan_bar(to2.scans.numpy(), jo2.scans, float(tp.rtex.cell))
    for f in ("collisions", "lap_counts", "toggle_list", "steer_cnt", "step_idx"):
        np.testing.assert_array_equal(getattr(ts2, f).numpy(),
                                      np.asarray(getattr(js2, f)), err_msg=f)


def test_f110env_reset_and_step(tmp_path, monkeypatch):
    """The gym-style wrapper: reference obs keys, shapes and a clean step."""
    monkeypatch.setenv("RED_GYM_TPU_TEXTURE_CACHE", str(tmp_path))
    env = tenv.F110Env(map=assets.named_map_yaml(TRACK), num_beams=B,
                       rt_pose_stride=8)
    obs, reward, done, info = env.reset(assets.waypoint_start_poses(TRACK, A))
    assert reward == pytest.approx(0.01)
    assert not done
    obs, reward, done, info = env.step(np.array([[0.0, 2.0], [0.0, 2.0]]))
    assert set(obs) == {"scans", "poses_x", "poses_y", "poses_theta",
                        "linear_vels_x", "linear_vels_y", "ang_vels_z",
                        "collisions", "lap_times", "lap_counts", "ego_idx"}
    assert obs["scans"].shape == (A, B)
    assert np.isfinite(obs["scans"]).all() and obs["scans"].max() > 1.0
    assert info["checkpoint_done"].shape == (A,)
    assert os.listdir(tmp_path), "texture cache not written"


@pytest.mark.parametrize("kw, item", [
    (dict(scan_mode="exact"), "the exact scan"),
    (dict(scan_interp="spectral"), "the other scan modes"),
    (dict(rt_spatial="bilinear"), "the other scan modes"),
    (dict(rt_occlusion="off"), "the other scan modes"),
    (dict(dtype="float64"), "the other scan modes"),
    (dict(noise_mode="pool_rot"), "kernel 1b"),
    (dict(fuse_scan_opp="on"), "kernel 1a"),
    (dict(state_kernel="on"), "kernel 2"),
    (dict(scan_megakernel="off"), "kernels 3-7"),
], ids=lambda v: v if isinstance(v, str) else ",".join(f"{k}={x}" for k, x in v.items()))
def test_unported_paths_raise_naming_their_roadmap_item(kw, item):
    cfg = TSimConfig(**{**dict(scan_mode="fast", num_beams=B), **kw})
    with pytest.raises(NotImplementedError, match=item):
        tenv.make_params(cfg, assets.named_map_yaml(TRACK))
