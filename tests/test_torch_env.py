"""The PyTorch port's env step, as a whole, against the JAX package.

JAX runs ``env.reset`` + 30 vmapped ``env.step`` calls with its scan
megakernel (interpret mode on the CPU); the port runs
``rollout.batched_reset`` / ``batched_step`` on the identical texture,
tables and vehicle (carried across by ``interop.params_from_numpy``), from
waypoint starts on track_0019 at texture stride 8, with the same numpy
actions.  Both noise pools are one identical numpy pool whose rows are all
equal, so each package's own row pick cannot matter.

Two configurations: the eager path (state kernel and fused opponent cast
off, row-pick pool noise) and the fully fused step (state kernel, opponent cast
in the megakernel, ``noise_mode="pool_rot"``; on the JAX side the
wrap-extended pool ``tables.noise_pool_ext`` is the all-equal pool too).

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
from red_gym_tpu_torch.ops import blend_kernels, scan_kernels, spectral_kernels, state_kernels

E, A, B = 160, 2, 270
STEPS = 30
TRACK = "track_0019"
CFG_KW = dict(num_agents=A, num_beams=B, dtype="float32", scan_mode="fast",
              rt_pose_stride=8, scan_backend="pallas", fuse_scan_ttc="on",
              scan_megakernel="on", fuse_scan_opp="off", state_kernel="off",
              rt_ew_dtype="float32", ttc_thresh=2.0)
FUSED_KW = dict(CFG_KW, fuse_scan_opp="on", state_kernel="on",
                noise_mode="pool_rot")


def _leaves(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items() if v is not None}


def _scan_bar(a, b, cell):
    err = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    assert np.quantile(err, 0.99) < 1e-3, np.quantile(err, 0.99)
    assert np.mean(err > 4 * cell) < 2e-3, np.mean(err > 4 * cell)


def _setup(cfg_kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RED_GYM_TPU_TEXTURE_CACHE", "off")
        cfg_j = JSimConfig(**cfg_kw)
        jp = jenv.make_params(cfg_j, assets.named_map_yaml(TRACK))
    return _setup_from(cfg_j, jp, TSimConfig(**cfg_kw))


def _setup_from(cfg_j, jp, cfg_t):
    """(cfg_j, jp, cfg_t, tp, poses, actions): JAX params with an all-equal
    bf16 noise pool, the port's params carried across from them, waypoint
    start poses and numpy actions."""
    torch.set_num_threads(2)
    rng = np.random.default_rng(0)
    row = rng.normal(0.0, 0.01, (1, B)).astype(np.float32)
    pool = np.repeat(row, cfg_j.noise_pool_rows, axis=0)
    jp = jp._replace(noise_pool=jnp.asarray(pool).astype(jnp.bfloat16))
    if jp.tables.noise_pool_ext is not None:
        ext = np.repeat(row, jp.tables.noise_pool_ext.shape[0], axis=0)
        jp = jp._replace(tables=jp.tables._replace(
            noise_pool_ext=jnp.asarray(ext).astype(jnp.bfloat16)))

    tp = interop.params_from_numpy(
        cfg_t, _leaves(jp.vehicle), _leaves(jp.tables), _leaves(jp.tmap),
        _leaves(jp.rtex), np.asarray(jp.noise_pool), device="cpu")
    poses = np.tile(assets.waypoint_start_poses(TRACK, A)[None], (E, 1, 1))
    actions = np.stack([rng.uniform(-0.4, 0.4, (STEPS + 1, E, A)),
                        rng.uniform(1.0, 8.0, (STEPS + 1, E, A))],
                       axis=-1).astype(np.float32)
    return cfg_j, jp, cfg_t, tp, poses.astype(np.float32), actions


@pytest.fixture(scope="module")
def setup():
    return _setup(CFG_KW)


@pytest.fixture(scope="module")
def setup_fused():
    setup = _setup(FUSED_KW)
    assert setup[1].tables.noise_pool_ext is not None, "JAX pool_rot fell back"
    return setup


def _jax_step(cfg_j, jp):
    return jax.jit(jax.vmap(lambda s, a: jenv.step(cfg_j, jp, s, a)))


def test_step_sequence_matches_jax(setup):
    _check_step_sequence(setup)


def test_fused_step_sequence_matches_jax(setup_fused):
    """The fully fused step: prestep + megakernel with opponents + pool_rot
    (the port's twins on the CPU, JAX's interpret-mode kernels)."""
    _check_step_sequence(setup_fused)


def _check_step_sequence(setup):
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
    _check_auto_reset_step(setup)


def test_fused_rollout_auto_reset_step_matches_jax(setup_fused):
    _check_auto_reset_step(setup_fused)


def _check_auto_reset_step(setup):
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

    state = interop.state_from_numpy(_leaves(js), device="cpu")
    obs = tenv.Observation(*[interop.to_tensor(np.asarray(v), device="cpu") for v in jo])
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
    """The gym-style wrapper in the fast scan: reference obs keys, shapes
    and a clean step (its default, the exact scan, is test_torch_exact.py's)."""
    monkeypatch.setenv("RED_GYM_TPU_TEXTURE_CACHE", str(tmp_path))
    env = tenv.F110Env(map=assets.named_map_yaml(TRACK), num_beams=B,
                       scan_mode="fast", rt_pose_stride=8, device="cpu")
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


def test_f110env_spectral_reset_and_step(tmp_path, monkeypatch):
    """The gym-style wrapper in bench.py's ``ultra`` mode (spectral theta,
    1-channel texture): the spectral render with noise and iTTC steps, and
    the render kernel's twin is what ran."""
    from red_gym_tpu_torch.ops import spectral_kernels

    monkeypatch.setenv("RED_GYM_TPU_TEXTURE_CACHE", str(tmp_path))
    calls = []
    real = spectral_kernels.theta_spectral_ttc
    monkeypatch.setattr(spectral_kernels, "theta_spectral_ttc",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    env = tenv.F110Env(map=assets.named_map_yaml(TRACK), num_beams=B,
                       scan_mode="fast", rt_pose_stride=8, scan_interp="spectral",
                       rt_grad=False, rt_occlusion="off", device="cpu")
    assert env.params.rtex.rt.shape[1] == env.cfg.rt_theta_bins
    obs, _, done, _ = env.reset(assets.waypoint_start_poses(TRACK, A))
    for _ in range(3):
        obs, _, done, _ = env.step(np.array([[0.0, 2.0], [0.0, 2.0]]))
    assert len(calls) == 4 and not done
    assert obs["scans"].shape == (A, B)
    assert np.isfinite(obs["scans"]).all() and obs["scans"].max() > 1.0


def _kw_id(v):
    return v if isinstance(v, str) else ",".join(f"{k}={x}" for k, x in v.items())


@pytest.mark.parametrize("kw, item", [
    (dict(dtype="float64"), "the float64 fast scan"),
    (dict(scan_backend="xla"), "scan_backend='xla'"),
], ids=_kw_id)
def test_unported_paths_raise_naming_their_roadmap_item(kw, item, monkeypatch):
    """The two paths that raised before ROADMAP A6 was ported (the float64
    fast scan, ``scan_backend='xla'``) now build and step: ``make_params``
    builds the texture, and one step runs JAX's XLA branches eagerly, with
    no scan kernel (no twin on the CPU) called.  tests/test_torch_fast64.py
    holds them against JAX.  The name is the one the test had while these
    paths raised; it is kept so that the test's record stays one record:
    read it as "the paths that were unported now run without kernels"."""
    monkeypatch.setenv("RED_GYM_TPU_TEXTURE_CACHE", "off")
    calls = []
    for mod, name in ((scan_kernels, "mega_edge_ttc"),
                      (spectral_kernels, "theta_spectral_ttc"),
                      (state_kernels, "prestep"),
                      *((blend_kernels, f.__name__) for f in blend_kernels.KERNELS)):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, **k: calls.append(1) or _r(*a, **k))
    cfg = TSimConfig(**{**dict(scan_mode="fast", num_beams=B, rt_pose_stride=16,
                               rt_theta_bins=16), **kw})
    params = tenv.make_params(cfg, assets.named_map_yaml(TRACK), device="cpu")
    assert params.rtex is not None and params.rtex.fmat.dtype == cfg.tdtype, item
    poses = torch.as_tensor(assets.waypoint_start_poses(TRACK, A)[None], dtype=cfg.tdtype)
    gen = torch.Generator().manual_seed(0)
    state, obs, *_ = tenv.reset(cfg, params, poses, gen)
    state, obs, *_ = tenv.step(cfg, params, state,
                               torch.tensor([[[0.0, 2.0], [0.0, 2.0]]], dtype=cfg.tdtype), gen)
    assert obs.scans.shape == (1, A, B) and obs.scans.dtype == cfg.tdtype
    assert torch.isfinite(obs.scans).all() and float(obs.scans.max()) > 1.0
    assert calls == [], f"{item}: a scan kernel ran"


@pytest.mark.parametrize("kw, knob", [
    (dict(rt_occlusion="off", fuse_scan_ttc="on"), "fuse_scan_ttc='on'"),
    (dict(rt_spatial="bilinear", fuse_scan_ttc="off", fuse_scan_opp="on"),
     "fuse_scan_opp='on'"),
    (dict(rt_spatial="bilinear", scan_megakernel="on"), "scan_megakernel='on'"),
    # the spectral render kernel has no opponent form (JAX raises alike)
    (dict(scan_interp="spectral", fuse_scan_ttc="on", fuse_scan_opp="on"),
     "fuse_scan_opp='on'"),
], ids=_kw_id)
def test_kernel_knob_on_out_of_scope_raises(kw, knob):
    cfg = TSimConfig(**{**dict(scan_mode="fast", num_beams=B), **kw})
    with pytest.raises(ValueError, match=knob):
        tenv.make_params(cfg, assets.named_map_yaml(TRACK), device="cpu")


@pytest.fixture(scope="module")
def texture_cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("rtex"))


@pytest.mark.parametrize("kw", [
    dict(rt_spatial="bilinear"), dict(rt_occlusion="off"),
    dict(scan_megakernel="off"), dict(scan_interp="spectral"),
    dict(scan_interp="spectral", fuse_scan_ttc="off")], ids=_kw_id)
def test_ported_modes_build_and_step(kw, texture_cache, monkeypatch):
    """The modes the unfused and spectral scans port build their params and
    step: a reset and two steps of 4 envs give finite scans of the right
    shape."""
    monkeypatch.setenv("RED_GYM_TPU_TEXTURE_CACHE", texture_cache)
    cfg = TSimConfig(**{**dict(scan_mode="fast", num_beams=B, rt_pose_stride=8), **kw})
    params = tenv.make_params(cfg, assets.named_map_yaml(TRACK), device="cpu")
    assert params.rtex.rt.shape[1] == cfg.rt_channels * cfg.rt_theta_bins
    poses = torch.as_tensor(np.tile(assets.waypoint_start_poses(TRACK, A)[None],
                                    (4, 1, 1)), dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    state, obs, *_ = trollout.batched_reset(cfg, params, poses, gen)
    for _ in range(2):
        state, obs, *_ = trollout.batched_step(
            cfg, params, state, torch.tensor([0.0, 3.0]).expand(4, A, 2), gen)
    assert obs.scans.shape == (4, A, B) and torch.isfinite(obs.scans).all()
    assert float(obs.scans.max()) > 1.0
