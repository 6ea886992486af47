"""The port's ``vec_env.VecF110Env`` against the JAX package's, on the CPU.

Both wrappers get the same constructor arguments, start poses and numpy
actions.  The JAX one resets every env at a done step and keeps the done
ones; the port restarts only the done envs (``rollout.reset_done``).  With
the scan noise off the two agree up to rounding:

- exact scan, float64, 8 envs x 2 agents x 108 beams on track_0019, the
  ego of env e turned by e * 45 degrees so that cars drive into the wall:
  states (poses, velocities, the whole ``x``) within 1e-10 over 20 steps;
  scans at the float64 exact-scan bar (|diff| <= 1e-9 m on >= 99.9 % of
  rays, tests/test_torch_exact.py); collisions, dones, lap counts, the
  auto-reset observations and ``final_obs`` exactly equal or at those bars;
- fast scan, float32 (the megakernel with opponents and the state kernel:
  JAX's interpret-mode kernels, the port's twins), both fed one identical
  texture and one all-equal noise pool as in tests/test_torch_env.py:
  poses within 1e-4 m, scans at the float32 scan bar, collisions and dones
  equal.

Port only: ``randomize_starts`` (each restarted env sits at its drawn map's
start row, maps in range), ``auto_reset=False``, the broadcast of one pose
set, and the constructor errors, which equal JAX's.
"""

import numpy as np
import pytest
import torch

from red_gym_tpu.vec_env import VecF110Env as JVec
from red_gym_tpu_torch import assets, interop
from red_gym_tpu_torch.vec_env import VecF110Env as TVec, numpy_step

TRACK = "track_0019"
E, A, B = 8, 2, 108
STEPS = 20
EXACT_KW = dict(num_agents=A, num_beams=B, dtype="float64", scan_noise_std=0.0,
                ttc_thresh=2.0, return_final_obs=True)
FAST_KW = dict(num_agents=A, num_beams=B, dtype="float32", scan_mode="fast",
               rt_pose_stride=8, scan_backend="pallas", fuse_scan_ttc="on",
               scan_megakernel="on", fuse_scan_opp="on", state_kernel="on",
               rt_ew_dtype="float32", ttc_thresh=2.0, return_final_obs=True)
FIELDS = ("scans", "poses_x", "poses_y", "poses_theta", "linear_vels_x", "linear_vels_y",
          "ang_vels_z", "collisions", "lap_times", "lap_counts")


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _poses():
    """(E, A, 3): waypoint starts, env e's ego turned by e * 45 degrees."""
    poses = np.tile(assets.waypoint_start_poses(TRACK, A)[None], (E, 1, 1))
    poses[:, 0, 2] += np.arange(E) * np.pi / 4
    return poses


def _actions(steps, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-0.4, 0.4, (steps, E, A)),
                     rng.uniform(4.0, 20.0, (steps, E, A))], axis=-1)


def _f64_bar(t, j):
    err = np.abs(np.asarray(t, np.float64) - np.asarray(j, np.float64))
    assert np.mean(err <= 1e-9) >= 0.999, np.mean(err <= 1e-9)


def _f32_bar(t, j, cell):
    err = np.abs(np.asarray(t, np.float64) - np.asarray(j, np.float64))
    assert np.quantile(err, 0.99) < 1e-3, np.quantile(err, 0.99)
    assert np.mean(err > 4 * cell) < 2e-3, np.mean(err > 4 * cell)


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _record(wrapper, obs, reward, done, info):
    """One reset or step of either wrapper as numpy: the states' x, obs,
    reward, done, checkpoint_done and final_obs."""
    fields = lambda d: {k: _np(d[k]) for k in FIELDS}  # noqa: E731
    fin = info.get("final_obs")
    return dict(x=_np(wrapper.states.x), obs=fields(obs), reward=_np(reward),
                done=_np(done), checkpoint_done=_np(info["checkpoint_done"]),
                final_obs=None if fin is None else fields(fin))


def _run(j, t, steps, poses, actions):
    """Reset both wrappers and step them: a list of (jax, port) records."""
    rec = [(_record(j, *j.reset(poses)), _record(t, *t.reset(poses)))]
    for i in range(steps):
        rec.append((_record(j, *j.step(actions[i])), _record(t, *t.step(actions[i]))))
    return rec


@pytest.fixture(scope="module")
def exact_run():
    yaml = assets.named_map_yaml(TRACK)
    j = JVec(yaml, E, **EXACT_KW)
    t = TVec(yaml, E, device="cpu", **EXACT_KW)
    return _run(j, t, STEPS, _poses(), _actions(STEPS))


def test_exact_states_match_jax(exact_run):
    """Poses, velocities and the whole dynamic state within 1e-10 at every
    step, the auto-reset steps included."""
    for i, (jr, tr) in enumerate(exact_run):
        np.testing.assert_allclose(tr["x"], jr["x"], rtol=0, atol=1e-10, err_msg=f"step {i}")


def test_exact_scans_match_jax(exact_run):
    for jr, tr in exact_run:
        _f64_bar(tr["obs"]["scans"], jr["obs"]["scans"])
        assert tr["obs"]["scans"].dtype == np.float64


def test_exact_collisions_dones_laps_match_jax(exact_run):
    n_done = 0
    for i, (jr, tr) in enumerate(exact_run):
        for k in ("done", "checkpoint_done", "reward"):
            np.testing.assert_array_equal(tr[k], jr[k], err_msg=f"{k} step {i}")
        for k in ("collisions", "lap_counts", "lap_times"):
            np.testing.assert_array_equal(tr["obs"][k], jr["obs"][k], err_msg=f"{k} step {i}")
        n_done += int(tr["done"].sum())
    # fixture guard: cars hit the wall, and not all at once
    assert n_done > 0
    assert not any(tr["done"].all() for _, tr in exact_run)


def test_exact_auto_reset_matches_jax(exact_run):
    """At a done step the returned observation is the restarted env's (at
    its start pose, collision cleared) and ``final_obs`` the terminal one,
    both as JAX's."""
    resets = 0
    for jr, tr in exact_run[1:]:
        np.testing.assert_array_equal(tr["final_obs"]["collisions"],
                                      jr["final_obs"]["collisions"])
        for k in FIELDS:
            if k in ("scans",):
                _f64_bar(tr["final_obs"][k], jr["final_obs"][k])
            else:
                np.testing.assert_allclose(tr["final_obs"][k], jr["final_obs"][k], rtol=0,
                                           atol=1e-10, err_msg=k)
        done = tr["done"]
        if done.any():
            resets += 1
            assert (tr["final_obs"]["collisions"][done, 0] == 1.0).all()
            assert (tr["obs"]["collisions"][done] == 0.0).all()
            np.testing.assert_allclose(tr["obs"]["poses_x"][done], _poses()[done][..., 0],
                                       rtol=0, atol=1e-12)
    assert resets > 0, "no auto-reset step in the fixture"


@pytest.fixture(scope="module")
def fast_run():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RED_GYM_TPU_TEXTURE_CACHE", "off")
        yaml = assets.named_map_yaml(TRACK)
        j = JVec(yaml, E, **FAST_KW)
        t = TVec(yaml, E, device="cpu", **FAST_KW)
    import jax.numpy as jnp

    row = np.random.default_rng(0).normal(0.0, 0.01, (1, B)).astype(np.float32)
    pool = np.repeat(row, j.cfg.noise_pool_rows, axis=0)
    j.params = j.params._replace(noise_pool=jnp.asarray(pool).astype(jnp.bfloat16))
    leaves = lambda nt: {k: np.asarray(v) for k, v in nt._asdict().items()  # noqa: E731
                         if v is not None}
    jp = j.params
    t.params = interop.params_from_numpy(t.cfg, leaves(jp.vehicle), leaves(jp.tables),
                                         leaves(jp.tmap), leaves(jp.rtex),
                                         np.asarray(jp.noise_pool), device="cpu")
    return float(t.params.rtex.cell), _run(j, t, STEPS, _poses(), _actions(STEPS))


def test_fast_scan_matches_jax(fast_run):
    cell, rec = fast_run
    n_coll = 0
    for i, (jr, tr) in enumerate(rec):
        np.testing.assert_allclose(tr["x"][..., [0, 1, 4]], jr["x"][..., [0, 1, 4]], rtol=0,
                                   atol=1e-4, err_msg=f"step {i}")
        np.testing.assert_array_equal(tr["done"], jr["done"])
        for o in ("obs", "final_obs") if i else ("obs",):
            _f32_bar(tr[o]["scans"], jr[o]["scans"], cell)
            np.testing.assert_array_equal(tr[o]["collisions"], jr[o]["collisions"])
        if i:
            n_coll += int(jr["final_obs"]["collisions"].sum())
    assert tr["obs"]["scans"].dtype == np.float32
    assert n_coll > 0, "no collisions in the fixture"


def _three_tracks():
    tracks = assets.packaged_tracks()[:3]
    return tracks, assets.start_pose_table(tracks, 1)


def test_randomize_starts_resets_onto_the_drawn_map():
    """Each restarted env's start pose is its drawn map's row of the table,
    and every map index lies in range; over the run the draws reach every
    map."""
    tracks, table = _three_tracks()
    t = TVec(tracks, 6, num_agents=1, num_beams=54, dtype="float64", march_iters=24,
             scan_noise_std=0.0, map_idx=np.zeros(6, np.int64), randomize_starts=table,
             ttc_thresh=2.0, device="cpu")
    t.reset(table[np.zeros(6, np.int64)])
    acts = np.tile([[0.0, 8.0]], (6, 1, 1))
    seen, restarted = set(), 0
    for _ in range(200):
        obs, reward, done, info = t.step(acts)
        m = t.states.map_idx.long()
        assert int(m.min()) >= 0 and int(m.max()) < len(tracks)
        if done.any():
            restarted += int(done.sum())
            want = torch.as_tensor(table, dtype=torch.float64)[m[done]]
            assert torch.equal(t.states.start_pose[done], want)
            assert torch.equal(obs["poses_x"][done], want[..., 0])
        seen.update(m.tolist())
        if len(seen) == len(tracks):
            break
    assert restarted > 0 and seen == {0, 1, 2}, (restarted, seen)
    assert torch.isfinite(obs["poses_x"]).all()


def test_multi_map_reset_matches_jax():
    """Envs on [map 0, map 1, map 0, map 1] at their tracks' starts: scans at
    the float64 bar against JAX, equal on one map, different across."""
    tracks, table = _three_tracks()
    tracks, table = tracks[:2], table[:2]
    kw = dict(num_agents=1, num_beams=54, dtype="float64", march_iters=24,
              scan_noise_std=0.0, map_idx=np.array([0, 1, 0, 1]))
    poses = np.tile(table, (2, 1, 1))
    jo, *_ = JVec([p[:-5] for p in tracks], 4, **kw).reset(poses)
    to, *_ = TVec([p[:-5] for p in tracks], 4, device="cpu", **kw).reset(poses)
    scans = to["scans"].numpy()
    _f64_bar(scans, np.asarray(jo["scans"]))
    np.testing.assert_array_equal(scans[0], scans[2])
    assert not np.allclose(scans[0], scans[1])


def test_auto_reset_off_keeps_done_envs():
    yaml = assets.named_map_yaml(TRACK)
    t = TVec(yaml, E, device="cpu", auto_reset=False, **EXACT_KW)
    t.reset(_poses())
    for act in _actions(STEPS):
        obs, _, done, info = t.step(act)
        if done.any():
            break
    assert done.any()
    for k in FIELDS:
        assert torch.equal(obs[k], info["final_obs"][k]), k
    assert (obs["collisions"][done, 0] == 1.0).all()


def test_one_pose_set_broadcasts_to_every_env():
    yaml = assets.named_map_yaml(TRACK)
    kw = dict(EXACT_KW, num_beams=54)
    one = TVec(yaml, 3, device="cpu", **kw).reset(assets.waypoint_start_poses(TRACK, A))
    each = TVec(yaml, 3, device="cpu", **kw).reset(
        np.tile(assets.waypoint_start_poses(TRACK, A)[None], (3, 1, 1)))
    for k in FIELDS:
        assert torch.equal(one[0][k], each[0][k]), k
    assert one[0]["scans"].shape == (3, A, 54) and one[0]["ego_idx"] == 0


def test_numpy_step_is_the_vector_api_form():
    yaml = assets.named_map_yaml(TRACK)
    t = TVec(yaml, E, device="cpu", **dict(EXACT_KW, num_beams=54))
    t.reset(_poses())
    obs, rew, term, trunc, infos = numpy_step(*t.step(_actions(1)[0]))
    assert obs["scans"].dtype == np.float32 and obs["scans"].shape == (E, A, 54)
    assert "ego_idx" not in obs
    assert rew.dtype == np.float32 and term.dtype == bool and not trunc.any()
    np.testing.assert_array_equal(infos["_final_obs"], term)
    assert set(infos["final_obs"]) == set(obs)


def _errors(make):
    tracks, table = _three_tracks()
    yaml = assets.named_map_yaml(TRACK)
    return {
        "unknown_kwarg": lambda: make(yaml, 2, num_agents=1, scan_modee="fast"),
        "randomize_needs_maps": lambda: make(yaml, 2, num_agents=1, num_beams=54,
                                             randomize_starts=table),
        "randomize_rows": lambda: make(tracks[:2], 2, num_agents=1, num_beams=54,
                                       randomize_starts=table),
    }


@pytest.mark.parametrize("case", ["unknown_kwarg", "randomize_needs_maps", "randomize_rows"])
def test_constructor_errors_equal_jax(case):
    with pytest.raises((TypeError, ValueError)) as want:
        _errors(JVec)[case]()
    with pytest.raises(want.type) as got:
        _errors(lambda *a, **k: TVec(*a, device="cpu", **k))[case]()
    assert str(got.value) == str(want.value)
