"""The port's state sanitizers (``utils/debug.py``) against the JAX package's.

JAX resets a batch in the exact scan (float64, no scan noise) on one map,
on two stacked maps with ``map_idx`` and with the maps on an env axis
(``map_axis=0``); the states and params are carried across with
``interop``.  Then, on the same numpy states with one violation injected at
a time, ``check_state``'s counts and ``env_health_mask`` equal JAX's, and
``quarantine_reset`` restarts exactly the flagged envs (as JAX does, within
1e-10 and at the float64 scan bar) and leaves every other env
``torch.equal``.  Mirrors tests/test_infra.py's sanitizer tests and
tests/test_failure_recovery.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from red_gym_tpu import env as jenv
from red_gym_tpu import rollout as jro
from red_gym_tpu.config import SimConfig as JSimConfig
from red_gym_tpu.maps.loader import load_map as jload_map, stack_maps as jstack_maps
from red_gym_tpu.utils import debug as jdebug
from red_gym_tpu_torch import assets, env as tenv, interop
from red_gym_tpu_torch.config import SimConfig as TSimConfig
from red_gym_tpu_torch.utils import debug as tdebug

CFG_KW = dict(num_agents=2, num_beams=54, dtype="float64", march_iters=16,
              scan_noise_std=0.0)
MODES = ("one_map", "map_idx", "map_axis")


def _leaves(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items() if v is not None}


def _jax_batch(mode):
    """(cfg, jax params, jax state, jax obs, map_axis) of a reset batch."""
    cfg = JSimConfig(**CFG_KW)
    tracks = assets.packaged_tracks()[:2]
    table = assets.start_pose_table(tracks, 2)
    if mode == "one_map":
        params = jenv.make_params(cfg, tracks[0])
        poses = np.tile(table[:1], (4, 1, 1))
        keys = jax.random.split(jax.random.PRNGKey(0), 4)
        states, obs, *_ = jax.vmap(lambda po, k: jenv.reset(cfg, params, po, k))(
            jnp.asarray(poses), keys)
        return cfg, params, states, obs, None
    if mode == "map_idx":
        params = jenv.make_multimap_params(cfg, tracks)
        midx = np.array([0, 1, 0, 1])
        keys = jax.random.split(jax.random.PRNGKey(0), 4)
        states, obs, *_ = jro.batched_reset(cfg, params, jnp.asarray(table[midx]), keys,
                                            map_idx=midx)
        return cfg, params, states, obs, None
    tracks = assets.packaged_tracks()[:3]          # env e on map e, 3 envs
    table = assets.start_pose_table(tracks, 2)
    raw = [jload_map(y, ".png", dtype=jnp.float64) for y in tracks]
    pad = (max(int(m.height) for m in raw), max(int(m.width) for m in raw))
    maps = [jload_map(y, ".png", dtype=jnp.float64, pad_to=pad) for y in tracks]
    params = jenv.make_params(cfg, tracks[0], tmap=raw[0])._replace(tmap=jstack_maps(maps))
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    states, obs, *_ = jro.batched_reset(cfg, params, jnp.asarray(table), keys, map_axis=0)
    assert states.map_idx is None
    return cfg, params, states, obs, 0


@pytest.fixture(scope="module", params=MODES)
def batch(request):
    cfg_j, jp, js, jo, map_axis = _jax_batch(request.param)
    cfg_t = TSimConfig(**CFG_KW)
    tp = interop.params_from_numpy(cfg_t, _leaves(jp.vehicle), _leaves(jp.tables),
                                   _leaves(jp.tmap), None, device="cpu")
    return dict(mode=request.param, cfg_j=cfg_j, jp=jp, js=js, jo=jo, cfg_t=cfg_t, tp=tp,
                map_axis=map_axis)


def _inject(js, case):
    """A copy of the JAX state with one violation (numpy, then jax)."""
    x = np.array(js.x)
    ct = np.array(js.current_time)
    if case == "nonfinite":
        x[0, 0, 3] = np.nan
    elif case == "off_map":
        x[1, 0, 0] = 1e6
    elif case == "over_speed":
        x[1, 1, 3] = 25.0
    elif case == "over_steer":
        x[-1, 0, 2] = 9.9
    elif case == "bad_yaw":
        x[0, 1, 4] = 20.0
    elif case == "bad_clock":
        ct[-1] = -1.0
    return js._replace(x=jnp.asarray(x), current_time=jnp.asarray(ct))


def _to_port(js):
    return interop.state_from_numpy(_leaves(js), device="cpu")


@pytest.mark.parametrize("case", ["healthy", "nonfinite", "off_map", "over_speed",
                                  "over_steer", "bad_yaw", "bad_clock"])
def test_check_state_counts_equal_jax(batch, case):
    js = _inject(batch["js"], case)
    want = jax.jit(jdebug.check_state, static_argnums=0)(batch["cfg_j"], batch["jp"], js)
    got = tdebug.check_state(batch["cfg_t"], batch["tp"], _to_port(js))
    assert {k: int(v) for k, v in got.items()} == {k: int(v) for k, v in want.items()}
    if case == "healthy":
        assert tdebug.explain(got) == []
        tdebug.assert_healthy(batch["cfg_t"], batch["tp"], _to_port(js))
    else:
        assert int(got[case]) >= 1
        assert any(f.startswith(case) for f in tdebug.explain(got))
        with pytest.raises(AssertionError, match=case):
            tdebug.assert_healthy(batch["cfg_t"], batch["tp"], _to_port(js))


def _poison(js):
    """NaN velocity on env 0, a whole opponent at +inf on the last env, and
    (with 4 envs) a huge but finite yaw rate on env 2: the stiff-dynamics
    stage before the first NaN.  Env 1 stays healthy."""
    x = np.array(js.x)
    x[0, 0, 3] = np.nan
    x[-1, 1, :] = np.inf
    if x.shape[0] > 3:
        x[2, 0, 5] = 1e35
    return js._replace(x=jnp.asarray(x))


def test_env_health_mask_equals_jax(batch):
    js = _poison(batch["js"])
    want = np.asarray(jdebug.env_health_mask(js))
    got = tdebug.env_health_mask(_to_port(js))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.tolist() == [False, True] + [False] * (len(want) - 2)
    assert bool(tdebug.env_health_mask(_to_port(batch["js"])).all())


def test_quarantine_reset_restarts_only_the_flagged_envs(batch):
    """The flagged envs restart finite at their start pose (as JAX's do, in
    float64 within 1e-10 and at the float64 scan bar); every other env keeps
    each field of its state and observation torch.equal."""
    cfg_t, tp, map_axis = batch["cfg_t"], batch["tp"], batch["map_axis"]
    js = _poison(batch["js"])
    # move the cars off their start so that a restart shows
    js = js._replace(x=js.x.at[..., 0].add(0.05), current_time=js.current_time + 1.0)
    state = _to_port(js)
    obs = tenv.Observation(*[torch.from_numpy(np.array(v)) for v in batch["jo"]])
    fixed, fobs, healthy = tdebug.quarantine_reset(cfg_t, tp, state, obs,
                                                   torch.Generator(), map_axis=map_axis)
    want_mask = np.asarray(jdebug.env_health_mask(js))
    np.testing.assert_array_equal(healthy.numpy(), want_mask)
    jfix, jobs, jmask = jax.jit(
        lambda s, o, k: jdebug.quarantine_reset(batch["cfg_j"], batch["jp"], s, o, k,
                                                map_axis=map_axis))(
        js, batch["jo"], jax.random.PRNGKey(7))
    np.testing.assert_array_equal(np.asarray(jmask), want_mask)
    bad = ~healthy
    assert torch.isfinite(fixed.x).all()
    np.testing.assert_allclose(fixed.x[bad].numpy(), np.asarray(jfix.x)[~want_mask],
                               rtol=0, atol=1e-10)
    err = np.abs(fobs.scans[bad].numpy() - np.asarray(jobs.scans)[~want_mask])
    assert np.mean(err <= 1e-9) >= 0.999
    assert torch.equal(fixed.current_time[bad],
                       torch.full_like(fixed.current_time[bad], cfg_t.timestep))
    assert (fixed.map_idx is None) == (state.map_idx is None)
    for name, a, b in [*zip(state._fields, fixed, state), *zip(obs._fields, fobs, obs)]:
        if b is not None:
            assert torch.equal(a[healthy], b[healthy]), name


def test_quarantine_reset_zeroes_a_poisoned_start_pose(batch):
    js = batch["js"]
    sp = np.array(js.start_pose)
    sp[0, 1, 0] = np.nan
    state = _to_port(js._replace(start_pose=jnp.asarray(sp)))
    obs = tenv.Observation(*[torch.from_numpy(np.array(v)) for v in batch["jo"]])
    fixed, _, healthy = tdebug.quarantine_reset(batch["cfg_t"], batch["tp"], state, obs,
                                                torch.Generator(), map_axis=batch["map_axis"])
    assert healthy.tolist() == [False] + [True] * (len(healthy) - 1)
    # the non-finite entry, and only it, is replaced by 0, as in JAX
    want = torch.from_numpy(np.nan_to_num(sp[0], nan=0.0))
    assert torch.equal(fixed.start_pose[0], want)
    assert torch.isfinite(fixed.x[0]).all()
    assert float(fixed.x[0, 1, 0]) == 0.0
