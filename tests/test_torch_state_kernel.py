"""The pre-scan state kernel's plain PyTorch twin against JAX, and the
port's env step with the state kernel on against off.

``state_kernels.prestep_reference`` is held against JAX's
``pallas_state.prestep`` in interpret mode on 160 envs x 2 cars of seeded,
in-range states and actions (free poses on track_0019 at texture stride 8),
for RK4 and Euler.  Bar: texture row, in-bounds flag, i_f and steer_cnt
exactly equal; x', the delay line, dx, dy and f_s within 1e-5 (float32;
positions reach tens of metres).  The port's ``env.step`` with
``state_kernel="on"`` must equal ``"off"`` bit for bit over 5 closed-loop
steps, as tests/test_scan_fast.py::test_state_kernel_matches_xla_chain
holds the JAX package.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from red_gym_tpu import env as jenv
from red_gym_tpu.config import Integrator as JIntegrator, SimConfig as JSimConfig
from red_gym_tpu.ops import pallas_state
from red_gym_tpu_torch import assets, env as tenv, interop, rollout
from red_gym_tpu_torch.config import Integrator, SimConfig as TSimConfig
from red_gym_tpu_torch.ops import state_kernels

E, A, B = 160, 2, 270
TRACK = "track_0019"
CFG_KW = dict(num_agents=A, num_beams=B, dtype="float32", scan_mode="fast",
              rt_pose_stride=8, scan_backend="pallas", fuse_scan_ttc="on",
              scan_megakernel="on")


def _leaves(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items() if v is not None}


@pytest.fixture(scope="module")
def jax_params():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RED_GYM_TPU_TEXTURE_CACHE", "off")
        return jenv.make_params(JSimConfig(**CFG_KW), assets.named_map_yaml(TRACK))


def _inputs(jp, seed=0):
    """Seeded in-range states: free poses, |v| below 0.5 for some cars (the
    kinematic branch), every delay-line fill count, mixed-sign actions.
    ``jp`` is JAX or port params: only numpy conversions are used."""
    rng = np.random.default_rng(seed)
    rtex, tmap = jp.rtex, jp.tmap
    valid = np.nonzero(np.asarray(rtex.valid))[0]
    wc, cell = int(rtex.wc), float(rtex.cell)
    pick = rng.choice(valid, E * A)
    x_rot = ((pick % wc) + rng.uniform(0, 1, E * A)) * cell
    y_rot = ((pick // wc) + rng.uniform(0, 1, E * A)) * cell
    oc, osn = float(tmap.orig_c), float(tmap.orig_s)
    x = np.zeros((E * A, 7))
    x[:, 0] = x_rot * oc - y_rot * osn + float(tmap.orig_x)
    x[:, 1] = x_rot * osn + y_rot * oc + float(tmap.orig_y)
    x[:, 2] = rng.uniform(-0.4, 0.4, E * A)
    x[:, 3] = np.where(rng.uniform(0, 1, E * A) < 0.2, rng.uniform(-0.5, 0.5, E * A),
                       rng.uniform(-3.0, 10.0, E * A))
    x[:, 4] = rng.uniform(0, 2 * np.pi, E * A)
    x[:, 5] = rng.uniform(-2.0, 2.0, E * A)
    x[:, 6] = rng.uniform(-0.3, 0.3, E * A)
    buf = rng.uniform(-0.4, 0.4, (E * A, 2))
    cnt = rng.integers(0, 3, E * A)
    act = np.stack([rng.uniform(-0.5, 0.5, E * A), rng.uniform(-3.0, 10.0, E * A)], -1)
    f32 = np.float32
    return (x.astype(f32).reshape(E, A, 7), buf.astype(f32).reshape(E, A, 2),
            cnt.astype(np.int32).reshape(E, A), act.astype(f32).reshape(E, A, 2))


@pytest.mark.parametrize("integrator", ["RK4", "EULER"])
def test_reference_matches_jax_kernel(jax_params, integrator):
    cfg_j = JSimConfig(**CFG_KW, integrator=JIntegrator[integrator])
    cfg_t = TSimConfig(**CFG_KW, integrator=Integrator[integrator])
    jp = jax_params
    x, buf, cnt, act = _inputs(jp)
    veh, geo_f, geo_i = pallas_state.pack_rows(jp, cfg_j)
    o = jax.vmap(lambda *a: pallas_state.prestep(cfg_j, *a, veh, geo_f, geo_i))(
        jnp.asarray(x), jnp.asarray(buf), jnp.asarray(cnt), jnp.asarray(act))
    o = [np.asarray(v) for v in o]

    tp = interop.params_from_numpy(cfg_t, _leaves(jp.vehicle), _leaves(jp.tables),
                                   _leaves(jp.tmap), _leaves(jp.rtex), device="cpu")
    # interop keeps the JAX package's 0-d vehicle scalars 0-d: in scope
    assert state_kernels.supported(cfg_t, tp)
    assert state_kernels.pack_params(tp.vehicle, tp.tmap, tp.rtex) is not None
    t_x, t_buf, t_cnt, t_rows, t_scal = state_kernels.prestep_reference(
        cfg_t, tp, torch.from_numpy(x), torch.from_numpy(buf),
        torch.from_numpy(cnt), torch.from_numpy(act))
    np.testing.assert_array_equal(t_rows.numpy(), o[15].astype(np.int32))
    np.testing.assert_array_equal(t_scal[..., 4].numpy(), o[14])
    np.testing.assert_array_equal(t_scal[..., 3].numpy(), o[13])
    np.testing.assert_array_equal(t_cnt.numpy(), o[9].astype(np.int32))
    np.testing.assert_allclose(t_x.numpy(), np.stack(o[0:7], -1), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_buf.numpy(), np.stack(o[7:9], -1), rtol=0, atol=0)
    for i, j in ((0, 10), (1, 11), (2, 12)):
        np.testing.assert_allclose(t_scal[..., i].numpy(), o[j], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(t_scal[..., 5].numpy(), t_x[..., 3].numpy())
    # fixture guards: both branches of the model, every delay-line state
    assert (np.abs(x[..., 3]) < 0.5).any() and (np.abs(x[..., 3]) >= 0.5).any()
    assert (t_cnt.numpy() == 2).any() and (t_cnt.numpy() == 1).any()


@pytest.fixture(scope="module")
def port_params(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RED_GYM_TPU_TEXTURE_CACHE", str(tmp_path_factory.mktemp("rtex")))
        cfg = TSimConfig(**CFG_KW)
        return cfg, tenv.make_params(cfg, assets.named_map_yaml(TRACK), device="cpu")


def test_env_step_state_kernel_on_equals_off(port_params):
    """5 closed-loop steps, pool noise and fused opponents, on vs off."""
    cfg, params = port_params
    poses = torch.as_tensor(np.tile(assets.waypoint_start_poses(TRACK, A)[None],
                                    (6, 1, 1)), dtype=torch.float32)

    def roll(state_kernel):
        c = dataclasses.replace(cfg, state_kernel=state_kernel)
        gen = torch.Generator().manual_seed(11)
        s, o, *_ = rollout.batched_reset(c, params, poses, gen)
        outs = []
        for t in range(5):
            a = torch.full((6, A, 2), 0.1 * (t + 1))
            s, o, r, d, _ = rollout.batched_step(c, params, s, a, gen)
            outs.append((o.scans, o.poses_x, o.poses_theta, o.collisions))
        return s, outs

    s_off, o_off = roll("off")
    s_on, o_on = roll("on")
    for a, b in zip(o_off, o_on):
        for u, v in zip(a, b):
            assert torch.equal(u, v)
    for f in ("x", "steer_buf", "steer_cnt"):
        assert torch.equal(getattr(s_off, f), getattr(s_on, f)), f
    assert state_kernels.prestep.launches == 0   # the twin runs on the CPU


def test_state_kernel_scope(port_params):
    """"on" outside the kernel's scope raises ValueError; "auto" there runs
    the eager chain; the dispatcher on CPU tensors is the twin."""
    cfg, params = port_params
    assert tenv.state_kernel_pack(cfg, params) is not None
    poses = torch.as_tensor(assets.waypoint_start_poses(TRACK, A)[None],
                            dtype=torch.float32)
    gen = torch.Generator()
    for kw in (dict(steer_delay=3), dict(speed_controller=lambda *a: (a[0], a[1]))):
        with pytest.raises(ValueError, match="state_kernel='on'"):
            tenv.reset(dataclasses.replace(cfg, state_kernel="on", **kw), params,
                       poses, gen)
        assert tenv.state_kernel_pack(dataclasses.replace(cfg, **kw), params) is None
    per_agent = params._replace(vehicle=params.vehicle.replace(mu=[1.0, 1.1]))
    assert not state_kernels.supported(cfg, per_agent)
    assert state_kernels.pack_params(per_agent.vehicle, params.tmap, params.rtex) is None
    tenv.reset(dataclasses.replace(cfg, steer_delay=3), params, poses, gen)

    x, buf, cnt, act = (torch.from_numpy(v)[:4] for v in _inputs(params))
    pack = state_kernels.pack_params(params.vehicle, params.tmap, params.rtex)
    out = state_kernels.prestep(cfg, params, x, buf, cnt, act, pack)
    ref = state_kernels.prestep_reference(cfg, params, x, buf, cnt, act)
    assert all(torch.equal(u, v) for u, v in zip(out, ref))
    with pytest.raises(ValueError, match="steer_buf"):
        state_kernels.prestep(cfg, params, x, buf[..., :1], cnt, act, pack)


@pytest.mark.parametrize("kw", [dict(scan_megakernel="off"),
                                dict(scan_megakernel="auto", rt_occlusion="off")],
                         ids=["megakernel_off", "occlusion_off"])
def test_state_kernel_needs_the_megakernel(port_params, kw):
    """Only the megakernel reads the state kernel's per-row operands, so
    the state kernel's scope needs the megakernel resolving on
    (red_gym_tpu/ops/pallas_state.py:192): there "auto" resolves off and
    "on" raises ValueError (red_gym_tpu/env.py:241-247)."""
    cfg, params = port_params
    off = dataclasses.replace(cfg, **kw)
    assert not state_kernels.supported(off, params)
    assert tenv.state_kernel_pack(off, params) is None
    with pytest.raises(ValueError, match="megakernel resolving on"):
        tenv.state_kernel_pack(dataclasses.replace(off, state_kernel="on"), params)
    on = dataclasses.replace(cfg, state_kernel="on")
    assert tenv.state_kernel_pack(on, params) is not None


def test_pack_params_layout(port_params):
    cfg, params = port_params
    pk = state_kernels.pack_params(params.vehicle, params.tmap, params.rtex)
    assert pk.shape == (state_kernels.PACK_LEN,) and pk.dtype == torch.float32
    assert float(pk[0]) == float(params.vehicle.mu)
    assert float(pk[22]) == float(params.rtex.cell)
    assert (int(pk[23]), int(pk[24])) == (int(params.rtex.hc), int(params.rtex.wc))
    assert not pk[25:].any()


def test_step_packs_the_params_it_is_given(port_params, monkeypatch):
    """Fault C1: the pack that env.step hands to prestep is built from the
    params of that step, so a replaced scalar vehicle field (mu) and a
    replaced map scalar (orig_x) reach the kernel, as JAX's pack_rows
    reads them at every step (red_gym_tpu/env.py:282)."""
    cfg, params = port_params
    new = params._replace(vehicle=params.vehicle.replace(mu=1.1),
                          tmap=params.tmap._replace(orig_x=params.tmap.orig_x + 0.25))
    assert state_kernels.supported(cfg, new)
    handed = []
    prestep = state_kernels.prestep

    def spy(*args):
        handed.append(args[-1])
        return prestep(*args)

    monkeypatch.setattr(state_kernels, "prestep", spy)
    poses = torch.as_tensor(assets.waypoint_start_poses(TRACK, A)[None],
                            dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    state, *_ = tenv.reset(cfg, params, poses, gen)
    tenv.step(cfg, new, state, torch.zeros((1, A, 2)), gen)
    old_pk = state_kernels.pack_params(params.vehicle, params.tmap, params.rtex)
    new_pk = state_kernels.pack_params(new.vehicle, new.tmap, new.rtex)
    assert len(handed) == 2
    assert torch.equal(handed[0], old_pk) and torch.equal(handed[1], new_pk)
    assert float(handed[1][0]) == float(torch.tensor(1.1))
    assert float(handed[1][18]) == float(new.tmap.orig_x) != float(old_pk[18])



def _spy_packs(monkeypatch) -> list:
    """Record the pack that every state_kernels.prestep call is handed."""
    handed = []
    prestep = state_kernels.prestep

    def spy(*args):
        handed.append(args[-1])
        return prestep(*args)

    monkeypatch.setattr(state_kernels, "prestep", spy)
    return handed


def _own_params(params):
    """params with vehicle tensors of their own, free to edit in place."""
    return params._replace(vehicle=params.vehicle._replace(
        **{f: getattr(params.vehicle, f).clone() for f in params.vehicle._fields}))


@pytest.mark.parametrize("change", ["in_place", "replace"])
def test_step_pack_follows_changed_params(port_params, monkeypatch, change):
    """Fault C1 under the pack cache (state_kernels.step_pack): after an
    in-place edit of a vehicle field (mu.fill_) or a replaced one (mu and
    the map's orig_x), the pack env.step hands to prestep equals a fresh
    pack_params of the params of that step, not the cached pack."""
    cfg, params = port_params
    own = _own_params(params)
    handed = _spy_packs(monkeypatch)
    poses = torch.as_tensor(assets.waypoint_start_poses(TRACK, A)[None],
                            dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    act = torch.zeros((1, A, 2))
    state, *_ = tenv.reset(cfg, own, poses, gen)
    old_pk = handed[-1].clone()
    if change == "in_place":
        own.vehicle.mu.fill_(1.1)
    else:
        own = own._replace(vehicle=own.vehicle.replace(mu=1.1),
                           tmap=own.tmap._replace(orig_x=own.tmap.orig_x + 0.25))
    tenv.step(cfg, own, state, act, gen)
    fresh = state_kernels.pack_params(own.vehicle, own.tmap, own.rtex)
    assert torch.equal(handed[-1], fresh)
    assert float(handed[-1][0]) == float(torch.tensor(1.1)) != float(old_pk[0])
    if change == "replace":
        assert float(handed[-1][18]) == float(own.tmap.orig_x) != float(old_pk[18])


def test_unchanged_step_reuses_the_cached_pack(port_params, monkeypatch):
    """Steps on params that did not change get the same pack tensor (no
    device op builds it again), whether the EnvParams object is the same
    or a new one around the same tensors; another cfg in scope gets a pack
    of the same values, and one out of scope none."""
    cfg, params = port_params
    own = _own_params(params)
    handed = _spy_packs(monkeypatch)
    poses = torch.as_tensor(assets.waypoint_start_poses(TRACK, A)[None],
                            dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    act = torch.zeros((1, A, 2))
    state, *_ = tenv.reset(cfg, own, poses, gen)
    state, *_ = tenv.step(cfg, own, state, act, gen)
    tenv.step(cfg, own._replace(noise_pool=own.noise_pool), state, act, gen)
    assert len(handed) == 3
    assert handed[1] is handed[0] and handed[2] is handed[0]
    assert torch.equal(handed[0], state_kernels.pack_params(own.vehicle, own.tmap, own.rtex))
    euler = dataclasses.replace(cfg, integrator=Integrator.EULER)
    assert torch.equal(state_kernels.step_pack(euler, own), handed[0])
    assert state_kernels.step_pack(dataclasses.replace(cfg, steer_delay=3), own) is None
    assert state_kernels.step_pack(cfg, own) is not None


def _inference_copy(v):
    """v with every tensor of its named-tuple tree cloned; under
    torch.inference_mode() the clones are inference tensors."""
    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, tuple) and hasattr(v, "_fields"):
        return type(v)(*(_inference_copy(f) for f in v))
    return v


def test_step_takes_params_made_under_inference_mode(port_params, monkeypatch):
    """Params made under torch.inference_mode(), as rollouts often make
    them, keep no version counter: env.step runs on them, and after an
    in-place edit (mu.fill_, allowed in inference mode) the pack it hands
    to prestep equals a fresh pack_params of the edited params."""
    cfg, params = port_params
    handed = _spy_packs(monkeypatch)
    poses = torch.as_tensor(assets.waypoint_start_poses(TRACK, A)[None],
                            dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    with torch.inference_mode():
        inf = _inference_copy(params)
        act = torch.zeros((1, A, 2))
        state, *_ = tenv.reset(cfg, inf, poses, gen)
        state, *_ = tenv.step(cfg, inf, state, act, gen)
        assert torch.equal(handed[-1], state_kernels.pack_params(params.vehicle, params.tmap,
                                                                 params.rtex))
        inf.vehicle.mu.fill_(1.1)
        tenv.step(cfg, inf, state, act, gen)
        fresh = state_kernels.pack_params(inf.vehicle, inf.tmap, inf.rtex)
    assert inf.vehicle.mu.is_inference() and inf.rtex.cell.is_inference()
    assert len(handed) == 3
    assert torch.equal(handed[-1], fresh)
    assert float(handed[-1][0]) == float(torch.tensor(1.1))
