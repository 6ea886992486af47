"""The port's exact scan (``scan_mode="exact"``, SimConfig's default) against
the JAX package, and the parts of ``F110Env`` that come with it.

The same numpy inputs go through both packages on the CPU: JAX's jitted
``lax.while_loop`` march, and the port's march twin
(``ops/march_kernels.py``, which the wrappers pick for CPU tensors).  The
env steps share the JAX params (``interop.params_from_numpy`` with no
texture) and one all-equal noise pool, so each package's own row pick
cannot matter.

Bars.  Theta indices: exactly equal.  Float64 ranges: |diff| <= 1e-9 m on
at least 99.9 % of rays (the march bar of
``test_torch_texture.py::test_march_matches_jax``; JAX's CPU code fuses
multiply-adds that the port rounds twice, and a last-bit difference can
move a ray's end by a cell).  Float32 ranges: the bar of
``tests/test_scan_fast.py:890-896`` with map cells in place of texture
cells: p99 |diff| < 1e-3 m, fewer than 0.2 % of beams off by more than 4
map cells.  Collisions, lap counts and done: exactly equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from red_gym_tpu import env as jenv
from red_gym_tpu import rollout as jrollout
from red_gym_tpu.config import SimConfig as JSimConfig
from red_gym_tpu.maps.loader import load_map as jload_map
from red_gym_tpu.ops import scan as jscan
from red_gym_tpu_torch import assets, env as tenv, interop, rollout as trollout
from red_gym_tpu_torch.config import SimConfig as TSimConfig
from red_gym_tpu_torch.maps import loader as tloader
from red_gym_tpu_torch.ops import march_kernels, scan as tscan
from red_gym_tpu_torch.ops import scan_fast as tsf, state_kernels

TRACK = "track_0019"
E, A, B = 8, 2, 270
STEPS = 30
STEP_KW = dict(num_agents=A, num_beams=B, ttc_thresh=2.0)


def _f64_bar(t, j):
    err = np.abs(np.asarray(t, np.float64) - np.asarray(j, np.float64))
    assert np.mean(err <= 1e-9) >= 0.999, np.mean(err <= 1e-9)


def _f32_bar(t, j, res):
    err = np.abs(np.asarray(t, np.float64) - np.asarray(j, np.float64))
    assert np.quantile(err, 0.99) < 1e-3, np.quantile(err, 0.99)
    assert np.mean(err > 4 * res) < 2e-3, np.mean(err > 4 * res)


def _scan_bar(dtype, t, j, res):
    if dtype == "float64":
        _f64_bar(t, j)
    else:
        _f32_bar(t, j, res)


def _leaves(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items() if v is not None}


def _maps(yaml_path, dtype):
    jdt, tdt = (jnp.float64, torch.float64) if dtype == "float64" else (jnp.float32,
                                                                         torch.float32)
    return (jload_map(yaml_path, ".png", dtype=jdt),
            tloader.load_map(yaml_path, dtype=tdt, device="cpu"))


def _free_poses(tmap, n, seed):
    """(n, 3) float64 poses at the centres of random cells with clearance
    above 0.3 m, random headings."""
    rng = np.random.default_rng(seed)
    dt = tmap.dt.numpy()
    cand = np.argwhere(dt > 0.3)
    cells = cand[rng.integers(0, len(cand), n)]
    res = float(tmap.resolution)
    x = (cells[:, 1] + 0.5) * res + float(tmap.orig_x)
    y = (cells[:, 0] + 0.5) * res + float(tmap.orig_y)
    return np.stack([x, y, rng.uniform(-np.pi, np.pi, n)], axis=-1)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# ops/scan.py: beam_theta_indices, trace, scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fov", [2 * np.pi, 4.7], ids=["fov2pi", "fov4.7"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_beam_theta_indices_equal_jax(dtype, fov):
    """Exactly the int32 indices of JAX's compiled env step, the wrap at
    2 pi included: headings at random and within 40 ulps of 0, +-pi, 2pi
    and +-fov/2."""
    cfg_kw = dict(num_beams=1080, fov=fov, dtype=dtype)
    np_dt = np.dtype(dtype)
    rng = np.random.default_rng(3)
    theta = [rng.uniform(-7.0, 7.0, 3000).astype(np_dt)]
    for c in (0.0, np.pi, -np.pi, 2 * np.pi, fov / 2, -fov / 2, fov / 2 - 2 * np.pi):
        up = dn = np_dt.type(c)
        near = [up]
        for _ in range(40):
            up = np.nextafter(up, np_dt.type(np.inf))
            dn = np.nextafter(dn, np_dt.type(-np.inf))
            near += [up, dn]
        theta.append(np.array(near, np_dt))
    theta = np.concatenate(theta)
    cfg_j = JSimConfig(**cfg_kw)
    want = np.asarray(jax.jit(lambda t: jscan.beam_theta_indices(t, cfg_j))(
        jnp.asarray(theta)))
    got = tscan.beam_theta_indices(torch.from_numpy(theta), TSimConfig(**cfg_kw))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.min() >= 0 and want.max() < cfg_j.theta_dis


@pytest.mark.parametrize("march_iters", [0, 40])
@pytest.mark.parametrize("track", [TRACK, "berlin"])
def test_trace_matches_jax(track, march_iters):
    """Float64 trace of 48 free poses x 1080 beams at the float64 bar."""
    if track == "berlin":
        from red_gym_tpu.maps.classic import classic_map_path

        yaml_path = classic_map_path("berlin")
    else:
        yaml_path = assets.named_map_yaml(track)
    cfg_kw = dict(num_agents=1, num_beams=1080, dtype="float64", march_iters=march_iters)
    cfg_j, cfg_t = JSimConfig(**cfg_kw), TSimConfig(**cfg_kw)
    jm, tm = _maps(yaml_path, "float64")
    poses = _free_poses(tm, 48, seed=7)
    jt = jscan.build_tables(cfg_j, 0.31, 0.58, dtype=jnp.float64)
    tt = tscan.build_tables(cfg_t, 0.31, 0.58, device="cpu")
    want = np.asarray(jax.jit(lambda p: jscan.trace(p, jt, jm, cfg_j))(jnp.asarray(poses)))
    got = tscan.trace(torch.from_numpy(poses), tt, tm, cfg_t).numpy()
    assert got.shape == (48, 1080)
    _f64_bar(got, want)
    assert (got > 0).all() and (got <= cfg_t.max_range).all()


@pytest.mark.parametrize("name", ["berlin", "skirk"])
def test_legacy_golden_scan(name):
    """The legacy C++ golden gate of tests/test_golden_scan.py for the
    port's float64 trace: MSE < 2.0 on 10 poses x 1080 beams at fov 4.7,
    and the port's scan at the float64 bar against JAX's."""
    import os

    from red_gym_tpu.maps.classic import classic_map_path

    golden = np.load(os.path.join(os.path.dirname(__file__), "golden",
                                  "legacy_scan.npz"))[name]
    cfg_kw = dict(num_agents=1, num_beams=1080, fov=4.7, dtype="float64")
    cfg_j, cfg_t = JSimConfig(**cfg_kw), TSimConfig(**cfg_kw)
    jm, tm = _maps(classic_map_path(name), "float64")
    poses = np.zeros((10, 3))
    poses[:, 2] = np.linspace(-1.0, 1.0, num=10)
    ours = tscan.trace(torch.from_numpy(poses),
                       tscan.build_tables(cfg_t, 0.31, 0.58, device="cpu"), tm, cfg_t).numpy()
    mse = float(np.mean((golden - ours) ** 2))
    print(f"legacy C++ golden scan [{name}], port: mse={mse:.6f} (gate 2.0)")
    assert mse < 2.0
    jt = jscan.build_tables(cfg_j, 0.31, 0.58, dtype=jnp.float64)
    _f64_bar(ours, np.asarray(jscan.trace(jnp.asarray(poses), jt, jm, cfg_j)))


def test_scan_adds_noise_from_the_generator():
    cfg = TSimConfig(num_beams=1080, dtype="float64", scan_noise_std=0.01)
    tm = tloader.load_map(assets.named_map_yaml(TRACK), dtype=torch.float64, device="cpu")
    tables = tscan.build_tables(cfg, 0.31, 0.58, device="cpu")
    poses = torch.from_numpy(_free_poses(tm, 16, seed=2))
    clean = tscan.trace(poses, tables, tm, cfg)
    assert torch.equal(tscan.scan(poses, None, tables, tm, cfg), clean)
    noisy = tscan.scan(poses, torch.Generator().manual_seed(0), tables, tm, cfg)
    assert abs(float((noisy - clean).std()) - 0.01) < 1e-3


# ---------------------------------------------------------------------------
# env.step and make_rollout in exact mode
# ---------------------------------------------------------------------------


def _setup(dtype):
    """(cfg_j, jp, cfg_t, tp, poses, actions): exact-mode JAX params with an
    all-equal pool, the port's params carried across (no texture), waypoint
    starts and numpy actions."""
    cfg_kw = dict(STEP_KW, dtype=dtype)
    cfg_j, cfg_t = JSimConfig(**cfg_kw), TSimConfig(**cfg_kw)
    jp = jenv.make_params(cfg_j, assets.named_map_yaml(TRACK))
    assert jp.rtex is None
    np_dt = np.dtype(dtype)
    rng = np.random.default_rng(0)
    row = rng.normal(0.0, 0.01, (1, B)).astype(np_dt)
    pool = np.repeat(row, cfg_j.noise_pool_rows, axis=0)
    jpool = jnp.asarray(pool)
    jp = jp._replace(noise_pool=jpool.astype(jnp.bfloat16) if dtype == "float32" else jpool)
    tp = interop.params_from_numpy(cfg_t, _leaves(jp.vehicle), _leaves(jp.tables),
                                   _leaves(jp.tmap), None, np.asarray(jp.noise_pool),
                                   device="cpu")
    poses = np.tile(assets.waypoint_start_poses(TRACK, A)[None], (E, 1, 1)).astype(np_dt)
    actions = np.stack([rng.uniform(-0.4, 0.4, (STEPS + 1, E, A)),
                        rng.uniform(1.0, 8.0, (STEPS + 1, E, A))], axis=-1).astype(np_dt)
    return cfg_j, jp, cfg_t, tp, poses, actions


@pytest.fixture(scope="module", params=["float64", "float32"])
def exact_setup(request):
    return request.param, _setup(request.param)


def _jax_step(cfg_j, jp):
    return jax.jit(jax.vmap(lambda s, a: jenv.step(cfg_j, jp, s, a)))


def test_exact_step_sequence_matches_jax(exact_setup):
    """Reset + 30 steps of 8 envs x 2 agents x 270 beams."""
    dtype, (cfg_j, jp, cfg_t, tp, poses, actions) = exact_setup
    res = float(tp.tmap.resolution)
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
        atol = 1e-9 if dtype == "float64" else 1e-4
        np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=0, atol=atol)
        _scan_bar(dtype, to.scans.numpy(), jo.scans, res)
        np.testing.assert_array_equal(ts.collisions.numpy(), np.asarray(js.collisions))
        np.testing.assert_array_equal(ts.lap_counts.numpy(), np.asarray(js.lap_counts))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        n_coll += int(np.asarray(js.collisions).sum())
    assert to.scans.dtype == cfg_t.tdtype
    assert n_coll > 0, "no collisions in the fixture"


def test_exact_rollout_auto_reset_step_matches_jax(exact_setup):
    """One make_rollout step with auto-reset, from one identical state."""
    dtype, (cfg_j, jp, cfg_t, tp, poses, actions) = exact_setup
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
    atol = 1e-9 if dtype == "float64" else 1e-4
    np.testing.assert_allclose(ts2.x.numpy(), np.asarray(js2.x), rtol=0, atol=atol)
    _scan_bar(dtype, to2.scans.numpy(), jo2.scans, float(tp.tmap.resolution))
    for f in ("collisions", "lap_counts", "toggle_list", "steer_cnt", "step_idx"):
        np.testing.assert_array_equal(getattr(ts2, f).numpy(),
                                      np.asarray(getattr(js2, f)), err_msg=f)


@pytest.mark.parametrize("knob", ["scan_megakernel", "fuse_scan_ttc", "fuse_scan_opp"])
def test_exact_mode_kernel_knob_on_raises(knob):
    """The fast scan's kernels resolve off in exact mode; "on" raises, as in
    JAX, before anything is built."""
    cfg = TSimConfig(num_beams=B, **{knob: "on"})
    assert not tsf.use_megakernel(dataclasses.replace(cfg, **{knob: "auto"}))
    with pytest.raises(ValueError, match=f"{knob}='on'"):
        tenv.make_params(cfg, assets.named_map_yaml(TRACK), device="cpu")


def test_exact_mode_state_kernel_on_raises():
    cfg = TSimConfig(num_beams=B, state_kernel="on")
    params = tenv.make_params(cfg, assets.named_map_yaml(TRACK), device="cpu")
    assert params.rtex is None
    poses = torch.as_tensor(assets.waypoint_start_poses(TRACK, A)[None], dtype=torch.float32)
    with pytest.raises(ValueError, match="state_kernel='on'"):
        tenv.reset(cfg, params, poses, torch.Generator())


# ---------------------------------------------------------------------------
# F110Env: the default scan mode, update_params, update_map
# ---------------------------------------------------------------------------

ACTIONS = np.array([[0.2, 3.0], [-0.1, 2.0]])


def _envs(yaml_path, **kw):
    """The JAX and the port's F110Env on one map with the same arguments."""
    j = jenv.F110Env(map=yaml_path, **kw)
    t = tenv.F110Env(map=yaml_path, device="cpu", **kw)
    return j, t


def _run_both(j, t, poses, steps):
    """Reset + ``steps`` steps of both; the port's observations checked
    against JAX's after each: scans at the float64 bar, poses within 1e-9,
    collisions, laps and done exactly equal."""
    outs = [(j.reset(poses), t.reset(poses))]
    outs += [(j.step(ACTIONS), t.step(ACTIONS)) for _ in range(steps)]
    for (jo, _, jd, _), (to, _, td, _) in outs:
        _f64_bar(to["scans"], jo["scans"])
        for k in ("poses_x", "poses_y", "poses_theta"):
            np.testing.assert_allclose(to[k], jo[k], rtol=0, atol=1e-9, err_msg=k)
        for k in ("collisions", "lap_counts"):
            np.testing.assert_array_equal(to[k], jo[k], err_msg=k)
        assert td == jd


def test_f110env_default_runs_the_exact_scan_as_jax():
    """Fault repair: with no scan_mode given, both packages' F110Env build
    SimConfig's default, the exact scan, and step alike."""
    j, t = _envs(assets.named_map_yaml(TRACK), dtype="float64", scan_noise_std=0.0)
    assert j.cfg.scan_mode == t.cfg.scan_mode == "exact"
    assert t.params.rtex is None
    _run_both(j, t, assets.waypoint_start_poses(TRACK, A), 5)


@pytest.mark.parametrize("index", [-1, 1])
def test_f110env_update_params_matches_jax(index):
    j, t = _envs(assets.named_map_yaml(TRACK), dtype="float64", scan_noise_std=0.0,
                 num_beams=B)
    update = {"mu": 0.8, "width": 0.4, "v_max": 12.0}
    j.update_params(update, index=index)
    t.update_params(update, index=index)
    for f in t.params.vehicle._fields:
        got = getattr(t.params.vehicle, f)
        want = np.asarray(getattr(j.params.vehicle, f))
        assert tuple(got.shape) == want.shape, f
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f)
    assert t.params.vehicle.mu.shape == ((A,) if index >= 0 else ())
    _run_both(j, t, assets.waypoint_start_poses(TRACK, A), 3)


def test_update_params_per_agent_leaves_the_state_kernel_scope(tmp_path, monkeypatch):
    """With index >= 0 the vehicle is per-agent: the state kernel's pack is
    None and the step runs the eager chain."""
    monkeypatch.setenv("RED_GYM_TPU_TEXTURE_CACHE", str(tmp_path))
    t = tenv.F110Env(map=assets.named_map_yaml(TRACK), num_beams=B, scan_mode="fast",
                     rt_pose_stride=8, device="cpu")
    assert tenv.state_kernel_pack(t.cfg, t.params) is not None
    t.update_params({"mu": 0.9}, index=1)
    assert tenv.state_kernel_pack(t.cfg, t.params) is None
    assert not state_kernels.supported(t.cfg, t.params)
    obs, *_ = t.reset(assets.waypoint_start_poses(TRACK, A))
    obs, *_ = t.step(ACTIONS)
    assert np.isfinite(obs["scans"]).all() and obs["scans"].shape == (A, B)


def test_f110env_update_map_exact_matches_jax():
    j, t = _envs(assets.named_map_yaml(TRACK), dtype="float64", scan_noise_std=0.0,
                 num_beams=B)
    other = assets.named_map_yaml("track_0007")
    j.update_map(other)
    t.update_map(other)
    assert t.params.rtex is None
    np.testing.assert_array_equal(t.params.tmap.dt.numpy(), np.asarray(j.params.tmap.dt))
    _run_both(j, t, assets.waypoint_start_poses("track_0007", A), 2)


def test_f110env_update_map_fast_rebuilds_the_texture(monkeypatch):
    monkeypatch.setenv("RED_GYM_TPU_TEXTURE_CACHE", "off")
    t = tenv.F110Env(map=assets.named_map_yaml(TRACK), num_beams=B, scan_mode="fast",
                     rt_pose_stride=8, device="cpu")
    other = assets.named_map_yaml("track_0007")
    t.update_map(other)
    want = tenv.make_params(t.cfg, other, device="cpu").rtex
    for f in want._fields:
        assert torch.equal(getattr(t.params.rtex, f), getattr(want, f)), f
    obs, *_ = t.reset(assets.waypoint_start_poses("track_0007", A))
    assert np.isfinite(obs["scans"]).all() and obs["scans"].max() > 1.0


def test_make_builds_an_f110env():
    t = tenv.make(assets.named_map_yaml(TRACK)[:-len(".yaml")], num_beams=B, device="cpu")
    assert isinstance(t, tenv.F110Env) and t.cfg.scan_mode == "exact"
    obs, reward, done, _ = t.reset(assets.waypoint_start_poses(TRACK, A))
    assert obs["scans"].shape == (A, B) and not done


# ---------------------------------------------------------------------------
# The dense texture build (RGT_TEXTURE_BUILD=dense)
# ---------------------------------------------------------------------------


def test_dense_build_matches_compact(monkeypatch):
    """The dense recipe (every bin localized, then the edge bins kept) and
    the compact one give the same texture, bit for bit, on the 40 x 40 map
    of tests/test_scan_fast.py::test_compact_build_matches_dense."""
    from tests.test_scan_fast import _tiny_tmap

    jm = _tiny_tmap(seed=11, n=40)
    tm = tloader.TrackMap(**{k: interop.to_tensor(np.asarray(v), device="cpu")
                             for k, v in jm._asdict().items()})
    cfg = TSimConfig(num_agents=1, num_beams=270, dtype="float64", scan_mode="fast",
                     rt_theta_bins=128, rt_pose_stride=4, rt_occlusion="edge",
                     rt_grad=True)
    monkeypatch.setenv("RED_GYM_TPU_TEXTURE_CACHE", "off")
    monkeypatch.delenv("RGT_TEXTURE_BUILD", raising=False)
    compact = tsf.build_range_texture(tm, cfg)
    monkeypatch.setenv("RGT_TEXTURE_BUILD", "dense")
    dense = tsf.build_range_texture(tm, cfg)
    assert torch.equal(compact.rt, dense.rt)
    assert torch.equal(compact.valid, dense.valid)
    # the edge channels are not all defaults: the edge bins were localized
    t_bins = cfg.rt_theta_bins
    assert (dense.rt[:, t_bins:2 * t_bins][dense.valid] != 0.5).any()


def test_march_twin_reads_the_out_of_map_cell():
    """A ray from outside the map reads dt[h-1, w-1] (the reference's
    quirk) in the twin, as the kernel does on the card."""
    cfg = TSimConfig(dtype="float64")
    tm = tloader.load_map(assets.named_map_yaml(TRACK), dtype=torch.float64, device="cpu")
    x = torch.tensor([float(tm.orig_x) - 5.0])
    y = torch.tensor([float(tm.orig_y) - 5.0])
    d = march_kernels.dt_lookup(x.double(), y.double(), tm)
    assert float(d) == float(tm.dt[-1, -1])
    out = march_kernels.march_reference(x.double(), y.double(), torch.tensor([1.0]).double(),
                                        torch.tensor([0.0]).double(), tm, cfg)
    assert out.shape == (1,) and 0.0 <= float(out) <= cfg.max_range
