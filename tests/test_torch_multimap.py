"""Multi-map batches of the port against the JAX package, and the port's own
multi-map properties.

The stack is [track_0019, classic/berlin]: resolution 0.0625 m against
0.05 m, another origin and another extent (920 x 875 against 600 x 600 px),
so a per-map scalar read as map 0's shows.  Envs alternate between the two
maps (``map_idx = [0, 1, 0, 1, ...]``) and start at random free poses of
their map, the second car within a metre of the first.  Both packages step
the same numpy actions; JAX runs its Pallas kernels in interpret mode, the
port its kernels' plain twins (CPU tensors).  Each package's noise pool is
one numpy pool whose rows are all equal, so its own row pick cannot
matter.

Bars.  Padding and stacking: exactly equal.  Exact scan (float64): ranges
within 1e-9 m on at least 99.9 % of rays, the march bar of
``test_torch_exact.py``; states within 1e-9; collisions, laps and done
exactly equal.  Fast scan (float32): the bar of tests/test_scan_fast.py:890-896
(p99 |diff| < 1e-3 m, fewer than 0.2 % of beams off by more than 4 texture
cells of the env's map), poses within 1e-4 m, collisions (the iTTC hits and
body hits), laps and done exactly equal.  Port-only properties: torch.equal.
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from red_gym_tpu import env as jenv
from red_gym_tpu import rollout as jrollout
from red_gym_tpu.config import SimConfig as JSimConfig
from red_gym_tpu.maps import loader as jloader
from red_gym_tpu.maps.classic import classic_map_path
from red_gym_tpu.ops import scan_fast as jsf
from red_gym_tpu_torch import assets, env as tenv, interop, rollout as trollout
from red_gym_tpu_torch.config import SimConfig as TSimConfig
from red_gym_tpu_torch.maps import loader as tloader
from red_gym_tpu_torch.ops import scan_fast as tsf, state_kernels

YAMLS = [assets.named_map_yaml("track_0019"), classic_map_path("berlin")]
E, A, B = 8, 2, 270
STEPS = 5
MIDX = (np.arange(E) % 2).astype(np.int32)
STRIDE = 16
# the megakernel config of test_torch_env.py, with the opponent cast in it
MEGA_KW = dict(num_agents=A, num_beams=B, dtype="float32", scan_mode="fast",
               rt_pose_stride=STRIDE, scan_backend="pallas", fuse_scan_ttc="on",
               scan_megakernel="on", fuse_scan_opp="on", state_kernel="off",
               rt_ew_dtype="float32", ttc_thresh=2.0)
FAST_KW = {
    "mega": MEGA_KW,
    # kernel 4's twin: bilinear cells, edge render with noise, iTTC, opponents
    "bilinear": dict(MEGA_KW, rt_spatial="bilinear", scan_megakernel="off"),
    # kernel 5's twin: the spectral render with noise and iTTC
    "spectral": dict(MEGA_KW, scan_interp="spectral", rt_grad=False,
                     rt_occlusion="off", scan_megakernel="off", fuse_scan_opp="off"),
}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def texture_cache(tmp_path_factory):
    """One texture cache for the module, so the JAX textures of each config
    are marched once."""
    return str(tmp_path_factory.mktemp("rtex"))


def _leaves(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items() if v is not None}


def _free_poses(tmaps, midx, seed):
    """(E, A, 3) float64 poses: car 0 of env e at a random cell centre of
    its map with more than 0.8 m of clearance, the others 0.9 m away from
    it at more than 0.4 m of clearance, random headings."""
    rng = np.random.default_rng(seed)
    out = np.zeros((len(midx), A, 3))
    for e, m in enumerate(midx):
        tm = tmaps[m]
        dt = np.asarray(tm.dt, np.float64)
        res, ox, oy = float(tm.resolution), float(tm.orig_x), float(tm.orig_y)

        def clear(x, y):
            c, r = int((x - ox) / res), int((y - oy) / res)
            return 0 <= r < dt.shape[0] and 0 <= c < dt.shape[1] and dt[r, c]

        cand = np.argwhere(dt > 0.8)
        while True:
            r, c = cand[rng.integers(len(cand))]
            x0, y0 = (c + 0.5) * res + ox, (r + 0.5) * res + oy
            phi = rng.uniform(0, 2 * np.pi, A - 1)
            xs, ys = x0 + 0.9 * np.cos(phi), y0 + 0.9 * np.sin(phi)
            if all((clear(x, y) or 0) > 0.4 for x, y in zip(xs, ys)):
                break
        out[e, 0, :2] = x0, y0
        out[e, 1:, 0], out[e, 1:, 1] = xs, ys
        out[e, :, 2] = rng.uniform(-np.pi, np.pi, A)
    return out


def _equal_pool(cfg_j, np_dt):
    row = np.random.default_rng(0).normal(0.0, 0.01, (1, B)).astype(np_dt)
    return np.repeat(row, cfg_j.noise_pool_rows, axis=0)


def _actions(np_dt, seed=1):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-0.4, 0.4, (STEPS, E, A)),
                     rng.uniform(1.0, 8.0, (STEPS, E, A))], axis=-1).astype(np_dt)


def _run_both(cfg_j, jp, cfg_t, tp, poses, actions, check):
    """Reset at ``poses`` on maps MIDX and step ``actions`` in both
    packages; ``check(ts, to, td, js, jo, jd)`` after each; -> collisions
    seen."""
    keys = jax.random.split(jax.random.PRNGKey(0), E)
    js, jo, _, jd, _ = jrollout.batched_reset(cfg_j, jp, jnp.asarray(poses), keys,
                                              map_idx=MIDX)
    gen = torch.Generator().manual_seed(0)
    ts, to, _, td, _ = trollout.batched_reset(cfg_t, tp, torch.from_numpy(poses), gen,
                                              map_idx=torch.from_numpy(MIDX))
    step_j = jax.jit(jax.vmap(lambda s, a: jenv.step(cfg_j, jp, s, a)))
    n_coll = 0
    for i in range(STEPS + 1):
        if i:
            js, jo, _, jd, _ = step_j(js, jnp.asarray(actions[i - 1]))
            ts, to, _, td, _ = trollout.batched_step(
                cfg_t, tp, ts, torch.from_numpy(actions[i - 1]), gen)
        assert torch.equal(ts.map_idx, torch.from_numpy(MIDX))
        check(ts, to, td, js, jo, jd)
        np.testing.assert_array_equal(ts.collisions.numpy(), np.asarray(js.collisions))
        np.testing.assert_array_equal(ts.lap_counts.numpy(), np.asarray(js.lap_counts))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        n_coll += int(np.asarray(js.collisions).sum())
    return n_coll


# ---------------------------------------------------------------------------
# padding and stacking
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_load_map_pad_to_and_stack_maps_equal_jax(dtype):
    jdt, tdt = (jnp.float64, torch.float64) if dtype == "float64" else (jnp.float32,
                                                                         torch.float32)
    raw = [tloader.load_map(y, dtype=tdt, device="cpu") for y in YAMLS]
    pad = (max(int(m.height) for m in raw), max(int(m.width) for m in raw))
    assert pad == (875, 920)
    jmaps = [jloader.load_map(y, ".png", dtype=jdt, pad_to=pad) for y in YAMLS]
    tmaps = [tloader.load_map(y, dtype=tdt, device="cpu", pad_to=pad) for y in YAMLS]
    for jm, tm, r in zip(jmaps, tmaps, raw):
        assert tm.dt.shape == pad and (int(tm.height), int(tm.width)) == r.dt.shape
        assert torch.equal(tm.dt, tloader.pad_map(r, pad).dt)
        for f in tloader.TrackMap._fields:
            np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)),
                                          err_msg=f)
    js, ts = jloader.stack_maps(jmaps), tloader.stack_maps(tmaps)
    for f in tloader.TrackMap._fields:
        assert getattr(ts, f).shape == np.asarray(getattr(js, f)).shape, f
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                      err_msg=f)
    with pytest.raises(ValueError, match="smaller than map"):
        tloader.load_map(YAMLS[0], dtype=tdt, device="cpu", pad_to=(600, 600))


def test_pad_and_stack_textures_equal_jax(texture_cache, monkeypatch):
    """JAX's raw textures of both maps carried across: the port's
    pad_texture and stack_textures give JAX's padded and stacked textures
    bit for bit."""
    monkeypatch.setenv("RED_GYM_TPU_TEXTURE_CACHE", texture_cache)
    cfg_j, cfg_t = JSimConfig(**MEGA_KW), TSimConfig(**MEGA_KW)
    raw = [jsf.build_range_texture(jloader.load_map(y, ".png", dtype=jnp.float32), cfg_j)
           for y in YAMLS]
    hc = max(int(r.hc) for r in raw)
    wc = max(int(r.wc) for r in raw)
    want = jsf.stack_textures([jsf.pad_texture(r, hc, wc) for r in raw])
    got = tsf.stack_textures([tsf.pad_texture(
        interop.texture_from_numpy(cfg_t, _leaves(r), device="cpu"), hc, wc) for r in raw])
    assert got.rt.shape == (2, hc * wc, 5 * cfg_t.rt_theta_bins)
    for f in ("rt", "valid", "hc", "wc", "cell", "fmat", "gmat", "smat"):
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        if g.dtype == torch.bfloat16:
            g, w = g.view(torch.int16), w.view(np.int16)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f)
    with pytest.raises(ValueError, match="smaller than texture"):
        tsf.pad_texture(interop.texture_from_numpy(cfg_t, _leaves(raw[0]), device="cpu"),
                        hc - 1, wc)


# ---------------------------------------------------------------------------
# env steps against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("march_iters", [0, 24])
def test_exact_multimap_matches_jax(march_iters):
    """make_multimap_params in exact mode, float64: reset + 5 steps of 8
    envs alternating between the two maps, each package's own params (the
    port's maps must equal JAX's)."""
    kw = dict(num_agents=A, num_beams=B, dtype="float64", ttc_thresh=2.0,
              march_iters=march_iters)
    cfg_j, cfg_t = JSimConfig(**kw), TSimConfig(**kw)
    jp = jenv.make_multimap_params(cfg_j, YAMLS)
    pool = _equal_pool(cfg_j, np.float64)
    jp = jp._replace(noise_pool=jnp.asarray(pool))
    tp = tenv.make_multimap_params(cfg_t, YAMLS, device="cpu")
    assert tp.rtex is None and tp.tmap.dt.shape == (2, 875, 920)
    for f in tloader.TrackMap._fields:
        np.testing.assert_array_equal(getattr(tp.tmap, f).numpy(),
                                      np.asarray(getattr(jp.tmap, f)), err_msg=f)
    tp = tp._replace(noise_pool=torch.from_numpy(pool))
    raw = [tloader.load_map(y, dtype=torch.float64, device="cpu") for y in YAMLS]
    poses = _free_poses(raw, MIDX, seed=3)

    def check(ts, to, td, js, jo, jd):
        np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=0, atol=1e-9)
        err = np.abs(to.scans.numpy() - np.asarray(jo.scans))
        assert np.mean(err <= 1e-9) >= 0.999, np.mean(err <= 1e-9)

    n_coll = _run_both(cfg_j, jp, cfg_t, tp, poses, _actions(np.float64), check)
    assert n_coll > 0, "no collisions in the fixture"


@pytest.mark.parametrize("mode", list(FAST_KW))
def test_fast_multimap_matches_jax(mode, texture_cache, monkeypatch):
    """JAX's make_multimap_params in float32 carried across (stacked maps
    and textures): reset + 5 steps on the megakernel config with opponents,
    on bilinear edge (kernel 4) and on spectral (kernel 5)."""
    monkeypatch.setenv("RED_GYM_TPU_TEXTURE_CACHE", texture_cache)
    cfg_j, cfg_t = JSimConfig(**FAST_KW[mode]), TSimConfig(**FAST_KW[mode])
    jp = jenv.make_multimap_params(cfg_j, YAMLS)
    pool = _equal_pool(cfg_j, np.float32)
    jp = jp._replace(noise_pool=jnp.asarray(pool).astype(jnp.bfloat16))
    tp = interop.params_from_numpy(cfg_t, _leaves(jp.vehicle), _leaves(jp.tables),
                                   _leaves(jp.tmap), _leaves(jp.rtex),
                                   np.asarray(jp.noise_pool), device="cpu")
    assert tp.rtex.rt.dim() == 3 and tp.tmap.dt.dim() == 3
    raw = [tloader.load_map(y, dtype=torch.float32, device="cpu") for y in YAMLS]
    poses = _free_poses(raw, MIDX, seed=4).astype(np.float32)
    cell = tp.rtex.cell.numpy()[MIDX][:, None, None]
    assert cell[0, 0, 0] != cell[1, 0, 0], "the maps' cells must differ"

    def check(ts, to, td, js, jo, jd):
        np.testing.assert_allclose(ts.x[..., [0, 1, 4]].numpy(),
                                   np.asarray(js.x)[..., [0, 1, 4]], rtol=0, atol=1e-4)
        err = np.abs(to.scans.numpy().astype(np.float64) - np.asarray(jo.scans))
        assert np.quantile(err, 0.99) < 1e-3, np.quantile(err, 0.99)
        assert np.mean(err > 4 * cell) < 2e-3, np.mean(err > 4 * cell)

    n_coll = _run_both(cfg_j, jp, cfg_t, tp, poses, _actions(np.float32), check)
    assert n_coll > 0, "no collisions in the fixture"


# ---------------------------------------------------------------------------
# the port's own properties
# ---------------------------------------------------------------------------


def _port_params(cfg, cache, monkeypatch):
    """The port's map-stacked params and each map's own params, built on
    the CPU, no scan noise (the stacked and standalone runs draw their
    noise rows from different batches)."""
    monkeypatch.setenv("RED_GYM_TPU_TEXTURE_CACHE", cache)
    stacked = tenv.make_multimap_params(cfg, YAMLS, device="cpu")
    alone = [tenv.make_params(cfg, y, device="cpu") for y in YAMLS]
    return stacked, alone


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_stacked_equals_standalone(mode, texture_cache, monkeypatch):
    """Each env of a stacked run reads only its own map and texture rows,
    and padding leaves them as they were: reset + 3 steps give, for every
    map, the envs of that map exactly the scans and states of the same
    poses and actions run on that map alone."""
    kw = dict(MEGA_KW, scan_noise_std=0.0)
    if mode == "exact":
        kw = dict(num_agents=A, num_beams=B, ttc_thresh=2.0, scan_noise_std=0.0)
    cfg = TSimConfig(**kw)
    stacked, alone = _port_params(cfg, texture_cache, monkeypatch)
    if mode == "fast":
        assert stacked.rtex.rt.shape[0] == 2 and stacked.rtex.hc[1] == stacked.rtex.hc[0]
    poses = torch.from_numpy(_free_poses([p.tmap for p in alone], MIDX, 5)).float()
    acts = torch.from_numpy(_actions(np.float32, seed=6))
    gen = torch.Generator().manual_seed(0)
    midx = torch.from_numpy(MIDX)
    runs = {"stacked": [trollout.batched_reset(cfg, stacked, poses, gen, map_idx=midx)[:2]]}
    for i in range(3):
        runs["stacked"].append(trollout.batched_step(cfg, stacked, runs["stacked"][-1][0],
                                                     acts[i], gen)[:2])
    for m, params in enumerate(alone):
        sel = torch.nonzero(midx == m).squeeze(1)
        seq = [trollout.batched_reset(cfg, params, poses[sel], gen)[:2]]
        for i in range(3):
            seq.append(trollout.batched_step(cfg, params, seq[-1][0], acts[i][sel], gen)[:2])
        for (ss, so), (ms, mo) in zip(runs["stacked"], seq):
            assert torch.equal(so.scans[sel], mo.scans)
            assert torch.equal(ss.x[sel], ms.x)
            assert torch.equal(ss.collisions[sel], ms.collisions)
        assert float(seq[-1][1].scans.max()) > 1.0


def test_map_axis_equals_map_idx():
    """map_axis=0 (maps stacked one an env) runs as map_idx = arange(E):
    the same states and scans through batched_reset, batched_step and an
    auto-resetting make_rollout; the state's map_idx stays None (JAX
    tests/test_infra.py:216)."""
    cfg = TSimConfig(num_agents=A, num_beams=B, ttc_thresh=2.0, scan_noise_std=0.0)
    params = tenv.make_multimap_params(cfg, YAMLS, device="cpu")
    e_n = 2
    poses = torch.from_numpy(_free_poses([tloader.load_map(y, device="cpu") for y in YAMLS],
                                         [0, 1], 8)).float()
    midx = torch.arange(e_n, dtype=torch.int32)
    g1, g2 = torch.Generator().manual_seed(0), torch.Generator().manual_seed(0)
    s1, o1, *_ = trollout.batched_reset(cfg, params, poses, g1, map_axis=0)
    s2, o2, *_ = trollout.batched_reset(cfg, params, poses, g2, map_idx=midx)
    assert s1.map_idx is None and torch.equal(s2.map_idx, midx)
    assert torch.equal(o1.scans, o2.scans) and torch.equal(s1.x, s2.x)
    act = torch.tensor([0.3, 6.0]).expand(e_n, A, 2)
    s1, o1, *_ = trollout.batched_step(cfg, params, s1, act, g1, map_axis=0)
    s2, o2, *_ = trollout.batched_step(cfg, params, s2, act, g2)
    assert s1.map_idx is None
    assert torch.equal(o1.scans, o2.scans) and torch.equal(s1.x, s2.x)

    def policy(obs, gen):
        return torch.tensor([0.35, 8.0]).expand(e_n, A, 2)

    (c1, outs1) = trollout.make_rollout(cfg, params, policy, 60, map_axis=0)(
        trollout.RolloutCarry(s1, o1), g1)
    (c2, outs2) = trollout.make_rollout(cfg, params, policy, 60)(
        trollout.RolloutCarry(s2, o2), g2)
    assert outs1["resets"] == outs2["resets"] > 0
    assert c1.state.map_idx is None and torch.equal(c2.state.map_idx, midx)
    assert torch.equal(c1.obs.scans, c2.obs.scans) and torch.equal(c1.state.x, c2.state.x)
    with pytest.raises(ValueError, match="one an env"):
        trollout.batched_reset(cfg, params, poses[:1], g1, map_axis=0)


def _kamikaze(e_n):
    """A policy that crashes fast: full speed, hard steer."""
    def policy(obs, gen):
        return torch.tensor([[0.35, 8.0]]).expand(e_n, 1, 2)
    return policy


@pytest.fixture(scope="module")
def three_tracks():
    """Three packaged tracks stacked in exact mode, one car, 54 beams, no
    noise (JAX tests/test_randomize.py's setup), and their start table."""
    tracks = assets.packaged_tracks()[:3]
    cfg = TSimConfig(num_agents=1, num_beams=54, scan_noise_std=0.0)
    params = tenv.make_multimap_params(cfg, tracks, device="cpu")
    return cfg, params, torch.as_tensor(assets.start_pose_table(tracks, 1),
                                        dtype=torch.float32)


def test_randomize_starts_draws_new_maps(three_tracks):
    """After a crashing policy, auto-resets drew at least two maps; every
    env's start pose is its map's row of the table; scans finite, >= 0
    (JAX tests/test_randomize.py)."""
    cfg, params, starts = three_tracks
    assert assets.packaged_tracks() == sorted(glob.glob(os.path.join(
        assets.DATA_DIR, "track_*.yaml")))
    e_n = 8
    midx = torch.zeros(e_n, dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    state, obs, *_ = trollout.batched_reset(cfg, params, starts[0].expand(e_n, 1, 3),
                                            gen, map_idx=midx)
    run = trollout.make_rollout(cfg, params, _kamikaze(e_n), 200, randomize_starts=starts)
    carry, outs = run(trollout.RolloutCarry(state, obs), gen)
    assert int(outs["done"].sum()) > 0, "nobody crashed: no resets exercised"
    final = carry.state.map_idx
    assert final.dtype == torch.int32 and len(torch.unique(final)) >= 2, final
    assert torch.equal(carry.state.start_pose, starts[final.long()])
    assert torch.isfinite(carry.obs.scans).all() and float(carry.obs.scans.min()) >= 0.0
    with pytest.raises(ValueError, match="randomize_starts needs map_idx"):
        run(trollout.RolloutCarry(state._replace(map_idx=None), obs), gen)
    with pytest.raises(ValueError, match="randomize_starts must be"):
        trollout.make_rollout(cfg, params, _kamikaze(e_n), 1, randomize_starts=starts[:2])


def test_collect_and_auto_reset_off(three_tracks):
    """collect stacks each step's observations (steps, E, ...);
    auto_reset=False leaves done envs as the step left them."""
    cfg, params, starts = three_tracks
    e_n, steps = 4, 120
    midx = torch.tensor([0, 1, 2, 0], dtype=torch.int32)
    gen = torch.Generator().manual_seed(1)
    state, obs, *_ = trollout.batched_reset(cfg, params, starts[midx.long()], gen,
                                            map_idx=midx)
    carry = trollout.RolloutCarry(state, obs)
    _, outs = trollout.make_rollout(cfg, params, _kamikaze(e_n), 3, collect=True)(carry, gen)
    assert outs["obs"].scans.shape == (3, e_n, 1, cfg.num_beams)
    assert outs["obs"].poses_x.shape == outs["obs"].lap_times.shape == (3, e_n, 1)
    assert outs["reward"].shape == outs["done"].shape == (3, e_n)
    c2, outs = trollout.make_rollout(cfg, params, _kamikaze(e_n), steps,
                                     auto_reset=False)(carry, gen)
    assert outs["resets"] == 0 and "obs" not in outs
    assert bool(outs["done"].any()), "nobody crashed"
    assert torch.equal(c2.state.step_idx, state.step_idx + steps)
    assert torch.equal(c2.state.map_idx, midx)
    assert torch.equal(c2.state.start_pose, state.start_pose)


def test_state_kernel_resolves_off_under_map_idx(texture_cache, monkeypatch):
    """state_kernel="auto" in the kernel's scope runs the eager chain under
    map_idx (JAX _use_state_kernel needs midx None); "on" raises."""
    cfg = TSimConfig(**dict(MEGA_KW, state_kernel="auto"))
    assert state_kernels.supported(cfg, tenv.make_params(cfg, YAMLS[1], device="cpu"))
    monkeypatch.setenv("RED_GYM_TPU_TEXTURE_CACHE", texture_cache)
    params = tenv.make_multimap_params(cfg, YAMLS, device="cpu")
    midx = torch.tensor([0, 1], dtype=torch.int32)
    assert tenv.state_kernel_pack(cfg, params, midx[:, None]) is None
    calls = []
    monkeypatch.setattr(state_kernels, "prestep", lambda *a, **k: calls.append(1))
    poses = torch.from_numpy(_free_poses([tloader.load_map(y, device="cpu")
                                          for y in YAMLS], [0, 1], 9)).float()
    gen = torch.Generator().manual_seed(0)
    state, obs, *_ = tenv.reset(cfg, params, poses, gen, map_idx=midx)
    assert not calls and torch.isfinite(obs.scans).all()
    with pytest.raises(ValueError, match="state_kernel='on'"):
        tenv.reset(dataclasses.replace(cfg, state_kernel="on"), params, poses, gen,
                   map_idx=midx)


def test_map_idx_is_checked_at_reset():
    cfg = TSimConfig(num_agents=A, num_beams=B)
    params = tenv.make_multimap_params(cfg, YAMLS, device="cpu")
    poses = torch.zeros((2, A, 3))
    gen = torch.Generator()
    with pytest.raises(ValueError, match=r"map_idx must lie in \[0, 2\)"):
        tenv.reset(cfg, params, poses, gen, map_idx=torch.tensor([0, 2]))
    with pytest.raises(ValueError, match="pass map_idx"):
        tenv.reset(cfg, params, poses, gen)
    one = tenv.make_params(cfg, YAMLS[0], device="cpu")
    with pytest.raises(ValueError, match="map_idx needs map-stacked params"):
        tenv.reset(cfg, one, poses, gen, map_idx=torch.tensor([0, 0]))


def test_interop_round_trips_map_idx():
    """A JAX state of map_idx envs carries its map index across (int32),
    and a state without one carries None."""
    cfg_j = JSimConfig(num_agents=A, num_beams=B)
    jp = jenv.make_multimap_params(cfg_j, YAMLS)
    raw = [tloader.load_map(y, device="cpu") for y in YAMLS]
    poses = jnp.asarray(_free_poses(raw, MIDX, 10))
    keys = jax.random.split(jax.random.PRNGKey(0), E)
    js, *_ = jrollout.batched_reset(cfg_j, jp, poses, keys, map_idx=MIDX)
    ts = interop.state_from_numpy(_leaves(js), device="cpu")
    assert ts.map_idx.dtype == torch.int32
    np.testing.assert_array_equal(ts.map_idx.numpy(), np.asarray(js.map_idx))
    js1 = js._replace(map_idx=None)
    assert interop.state_from_numpy(_leaves(js1), device="cpu").map_idx is None
