"""The port's PPO (red_gym_tpu_torch/agents/ppo.py) against the JAX package's,
and the port's own trainer properties.

Inputs are drawn with numpy from a seed and go through both packages on the
CPU.  The flax policy's params are carried across with
``interop.policy_from_numpy``.  JAX's ScanPolicy pins its two heads to
float32 (``nn.Dense(..., dtype=jnp.float32)``); the float64 comparisons run
those two Dense layers in float64 through flax's method interceptor
(``_f64_heads``), as the port's float64 policy does, so that both sides
compute every layer in float64.  A float32 forward is also held against
flax's own float32 heads.

Bars.  Float64 pieces, the loss and every gradient, and one update of 2
epochs x 2 minibatches: relative 1e-10.  ``collect`` in the exact scan,
float64, with ``log_std`` at -30 (actions equal the mean to about 1e-13)
and no scan noise: features, vels, values, rewards and final states within
1e-9, dones equal.  ``collect`` in the trainer's bilinear config, float32
(kernel 4's twin against JAX's interpret-mode kernel 4): the scan bar of
tests/test_scan_fast.py:890-896 on the final scans and on the stored
features, poses within 1e-4, dones and collisions equal.  Port-only
properties: torch.equal.
"""

import os
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from red_gym_tpu import env as jenv
from red_gym_tpu import rollout as jrollout
from red_gym_tpu.agents import ppo as jppo
from red_gym_tpu.agents import pure_pursuit as jpp
from red_gym_tpu.config import SimConfig as JSimConfig
from red_gym_tpu_torch import assets, env as tenv, interop, rollout as trollout
from red_gym_tpu_torch.agents import ppo as tppo
from red_gym_tpu_torch.agents import pure_pursuit as tpp
from red_gym_tpu_torch.config import SimConfig as TSimConfig
from red_gym_tpu_torch.utils import checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACK = "track_0019"
E, A, B = 8, 2, 64
HIDDEN, STRIDE = 32, 4
T = 32
RTOL = 1e-10
# exact scan, no scan noise; a 1 s iTTC horizon makes the envs that face a
# wall crash within the rollout while those along the track drive on
EXACT_KW = dict(num_agents=A, num_beams=B, dtype="float64", scan_noise_std=0.0,
                ttc_thresh=1.0)
# the trainer's scan (examples/train_ppo.py: fast, bilinear, edge + grad
# channels) with the kernels forced on in JAX, at a coarse texture stride
BILINEAR_KW = dict(num_agents=A, num_beams=270, dtype="float32", scan_mode="fast",
                   rt_spatial="bilinear", rt_pose_stride=16, scan_backend="pallas",
                   fuse_scan_ttc="on", fuse_scan_opp="on", scan_megakernel="off",
                   state_kernel="off", rt_ew_dtype="float32", scan_noise_std=0.0,
                   ttc_thresh=1.0)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _f64_heads(next_fun, args, kwargs, context):
    """Run flax Dense layers pinned to float32 (ScanPolicy's heads) in
    float64, with the same params."""
    m = context.module
    if (isinstance(m, fnn.Dense) and context.method_name == "__call__"
            and m.dtype == jnp.float32):
        return m.clone(parent=None, dtype=jnp.float64).apply(
            {"params": m.variables["params"]}, *args, **kwargs)
    return next_fun(*args, **kwargs)


def _rel(t, j, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(t.detach() if isinstance(t, torch.Tensor) else t),
                               np.asarray(j), rtol=rtol, atol=atol)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _policies(num_beams=B, dtype="float64", seed=0):
    """A flax ScanPolicy and its params, and the port's policy holding them."""
    jdt, tdt = (jnp.float64, torch.float64) if dtype == "float64" else (jnp.float32,
                                                                         torch.float32)
    jpol = jppo.ScanPolicy(hidden=HIDDEN, scan_stride=STRIDE, compute_dtype=jdt)
    params = jpol.init(jax.random.PRNGKey(seed), jnp.zeros((1, num_beams), jdt),
                       jnp.zeros((1,), jdt))
    params = jax.tree.map(lambda x: x.astype(jdt), params)
    tpol = tppo.ScanPolicy(num_beams, HIDDEN, scan_stride=STRIDE, compute_dtype=tdt).to(tdt)
    tpol.load_state_dict(interop.policy_from_numpy(_np_tree(params)))
    return jpol, params, tpol


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# pieces, float64
# ---------------------------------------------------------------------------


def test_featurize_scan_matches_jax():
    scans = np.random.default_rng(0).uniform(0.0, 30.0, (E, A, 1080))
    for stride in (4, 8):
        _rel(tppo.featurize_scan(_t(scans), stride, torch.float64),
             jppo.featurize_scan(jnp.asarray(scans), stride, jnp.float64))


@pytest.mark.parametrize("featurized", [False, True])
@pytest.mark.parametrize("shape", [(E,), (E, A)])
def test_policy_forward_matches_jax(shape, featurized):
    jpol, params, tpol = _policies()
    rng = np.random.default_rng(1)
    width = (B + STRIDE - 1) // STRIDE if featurized else B
    x = rng.uniform(0.0, 3.0 if featurized else 20.0, shape + (width,))
    v = rng.uniform(0.0, 8.0, shape)
    with fnn.intercept_methods(_f64_heads):
        jm, jls, jv = jpol.apply(params, jnp.asarray(x), jnp.asarray(v),
                                 featurized=featurized)
    tm, tls, tv = tpol(_t(x), _t(v), featurized=featurized)
    assert tm.shape == shape + (2,) and tv.shape == shape
    assert tm.dtype == tv.dtype == torch.float64
    _rel(tm, jm)
    _rel(tls, jls)
    _rel(tv, jv)


def test_float32_policy_matches_flax_heads():
    """The default float32 policy against flax's float32 heads, unpatched."""
    jpol, params, tpol = _policies(dtype="float32")
    rng = np.random.default_rng(2)
    x = rng.uniform(0.0, 20.0, (E, B)).astype(np.float32)
    v = rng.uniform(0.0, 8.0, (E,)).astype(np.float32)
    jm, _, jv = jpol.apply(params, jnp.asarray(x), jnp.asarray(v))
    tm, _, tv = tpol(_t(x), _t(v))
    assert tm.dtype == tv.dtype == torch.float32
    _rel(tm, jm, rtol=1e-5, atol=1e-6)
    _rel(tv, jv, rtol=1e-5, atol=1e-6)


def test_init_follows_flax_lecun_normal():
    """Kernels: std within 5 % of 1/sqrt(fan_in), nothing past 2 sigma of the
    untruncated normal; biases 0; log_std -0.5; a generator fixes them."""
    pol = tppo.ScanPolicy(1080, 256)
    pol.reset_parameters(torch.Generator().manual_seed(0))
    for lin in (pol.hidden_0, pol.hidden_1, pol.mean, pol.value):
        fan_in = lin.weight.shape[1]
        w = lin.weight.detach().double()
        target = 1.0 / np.sqrt(fan_in)
        if w.numel() >= 256 * 100:
            assert abs(float(w.std()) / target - 1.0) < 0.05, (fan_in, float(w.std()))
        assert float(w.abs().max()) <= 2.0 * target / tppo._TRUNC_STD + 1e-7
        assert torch.equal(lin.bias, torch.zeros_like(lin.bias))
    assert torch.equal(pol.log_std.detach(), torch.full((2,), -0.5))
    again = tppo.ScanPolicy(1080, 256)
    again.reset_parameters(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(pol.state_dict().values(),
                                                 again.state_dict().values()))
    # flax's own draw of the same layer has the same statistics
    jk = np.asarray(fnn.initializers.lecun_normal()(jax.random.PRNGKey(0), (256, 256)))
    assert abs(jk.std() * 16.0 - 1.0) < 0.05 and np.abs(jk).max() <= 2.0 / 16 / tppo._TRUNC_STD


def _obs_pair(rng, e=E):
    """A JAX Observation and the port's with the same random values."""
    fields = {f: rng.uniform(0.0, 5.0, (e, A)) for f in tenv.Observation._fields}
    fields["scans"] = rng.uniform(0.0, 20.0, (e, A, B))
    fields["collisions"] = (rng.uniform(size=(e, A)) < 0.3).astype(np.float64)
    return (jenv.Observation(**{k: jnp.asarray(v) for k, v in fields.items()}),
            tenv.Observation(**{k: _t(v) for k, v in fields.items()}))


def test_controls_logp_reward_match_jax():
    rng = np.random.default_rng(3)
    pcfg_j, pcfg_t = jppo.PPOConfig(), tppo.PPOConfig()
    act = rng.normal(0.0, 2.0, (E, 2))
    mean, log_std = rng.normal(0.0, 1.0, (E, 2)), rng.normal(-0.5, 0.3, (2,))
    _rel(tppo.action_to_control(_t(act), pcfg_t, torch.float64),
         jppo.action_to_control(jnp.asarray(act), pcfg_j, jnp.float64))
    _rel(tppo.gaussian_logp(_t(mean), _t(log_std), _t(act)),
         jppo.gaussian_logp(jnp.asarray(mean), jnp.asarray(log_std), jnp.asarray(act)))
    cfg_j, cfg_t = JSimConfig(**EXACT_KW), TSimConfig(**EXACT_KW)
    jo, to = _obs_pair(rng)
    jo2, to2 = _obs_pair(rng)
    for kw in ({}, {"speed_coef": 0.5, "collision_penalty": 3.0}):
        _rel(tppo.progress_collision_reward(**kw)(cfg_t, to, to2),
             jppo.progress_collision_reward(**kw)(cfg_j, jo, jo2))


@pytest.fixture(scope="module")
def exact64():
    """Exact-scan float64 params on track_0019 (JAX's, carried across) and
    the start poses of ``_poses_along``."""
    cfg_j, cfg_t = JSimConfig(**EXACT_KW), TSimConfig(**EXACT_KW)
    jp = jenv.make_params(cfg_j, assets.named_map_yaml(TRACK))
    tp = interop.params_from_numpy(cfg_t, _leaves(jp.vehicle), _leaves(jp.tables),
                                   _leaves(jp.tmap), None, device="cpu")
    poses = _poses_along(TRACK)
    return cfg_j, jp, cfg_t, tp, poses


def _leaves(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items() if v is not None}


def _ppo_pair(cfg_j, jp, cfg_t, tp, jpol, tpol, opp_j=None, opp_t=None):
    pcfg = dict(rollout_len=T, minibatches=2, epochs=2)
    return (jppo.PPO(cfg_j, jp, jppo.PPOConfig(**pcfg), policy=jpol, opponent_plan=opp_j),
            tppo.PPO(cfg_t, tp, tppo.PPOConfig(**pcfg), policy=tpol, opponent_plan=opp_t))


def _port_state(tpol, seed=0):
    opt = torch.optim.Adam(tpol.parameters(), lr=3e-4, betas=(0.9, 0.999), eps=1e-8)
    return tppo.PPOState(tpol, opt, torch.Generator().manual_seed(seed))


def test_gae_matches_jax():
    """Dones in the middle of the rollout."""
    rng = np.random.default_rng(4)
    values, rewards = rng.normal(0, 1, (T, E)), rng.normal(0, 1, (T, E))
    dones = (rng.uniform(size=(T, E)) < 0.15).astype(np.float64)
    assert dones[1:-1].any() and not dones.all()
    last = rng.normal(0, 1, (E,))
    jx = jppo.PPO(JSimConfig(**EXACT_KW), None)
    tx = tppo.PPO.__new__(tppo.PPO)
    tx.pcfg = tppo.PPOConfig()
    ja, jr = jx._gae(*map(jnp.asarray, (values, rewards, dones, last)))
    ta, tr = tx._gae(*map(_t, (values, rewards, dones, last)))
    _rel(ta, ja)
    _rel(tr, jr)


def _traj(rng, width, n_t=T, e=E):
    feats = rng.uniform(0.0, 3.0, (n_t, e, width))
    vels = rng.uniform(0.0, 8.0, (n_t, e))
    acts = rng.normal(0.0, 1.0, (n_t, e, 2))
    logps = rng.normal(-2.0, 0.5, (n_t, e))
    values = rng.normal(0.0, 1.0, (n_t, e))
    rewards = rng.normal(0.0, 0.1, (n_t, e))
    dones = (rng.uniform(size=(n_t, e)) < 0.1).astype(np.float64)
    return feats, vels, acts, logps, values, rewards, dones


def test_loss_and_gradients_match_jax(exact64):
    """A minibatch of 4 (a biased std would show): the loss, its aux terms and
    the gradient of every parameter, jax.grad against autograd."""
    cfg_j, jp, cfg_t, tp, _ = exact64
    jpol, params, tpol = _policies()
    jx, tx = _ppo_pair(cfg_j, jp, cfg_t, tp, jpol, tpol)
    rng = np.random.default_rng(5)
    feats, vels, acts, logps, _, _, _ = _traj(rng, (B + STRIDE - 1) // STRIDE, 1, 4)
    adv, ret = rng.normal(0, 1, (4,)), rng.normal(0, 1, (4,))
    batch = [feats[0], vels[0], acts[0], logps[0], adv, ret]
    with fnn.intercept_methods(_f64_heads):
        (jl, jaux), jg = jax.value_and_grad(jx._loss, has_aux=True)(
            params, tuple(map(jnp.asarray, batch)))
    tl, taux = tx._loss(tpol, [_t(b) for b in batch])
    tl.backward()
    _rel(tl, jl)
    for k in ("pg", "vf", "ratio"):
        _rel(taux[k], jaux[k])
    jgrads = interop.policy_from_numpy(_np_tree(jg))
    for name, p in tpol.named_parameters():
        _rel(p.grad, jgrads[name].numpy())


def test_one_update_matches_jax(exact64):
    """GAE and 2 epochs x 2 minibatches of Adam on one trajectory, with the
    permutations JAX draws: params and the mean loss within 1e-10."""
    cfg_j, jp, cfg_t, tp, _ = exact64
    jpol, params, tpol = _policies()
    jx, tx = _ppo_pair(cfg_j, jp, cfg_t, tp, jpol, tpol)
    rng = np.random.default_rng(6)
    n_t = 4
    traj = _traj(rng, (B + STRIDE - 1) // STRIDE, n_t)
    last = rng.normal(0, 1, (E,))
    feats, vels, acts, logps, values, rewards, dones = map(jnp.asarray, traj)

    adv, returns = jx._gae(values, rewards, dones, jnp.asarray(last))
    n = n_t * E
    flat = lambda x: x.reshape((n,) + x.shape[2:])  # noqa: E731
    data = tuple(map(flat, (feats, vels, acts, logps, adv, returns)))
    tx_j = optax.adam(3e-4)
    opt_state = tx_j.init(params)
    key, perms, losses = jax.random.PRNGKey(7), [], []
    mb = n // 2
    with fnn.intercept_methods(_f64_heads):
        for _ in range(2):
            key, kp = jax.random.split(key)
            perm = jax.random.permutation(kp, n)
            perms.append(_t(perm))
            for i in range(2):
                idx = perm[i * mb:(i + 1) * mb]
                (loss, _), grads = jax.value_and_grad(jx._loss, has_aux=True)(
                    params, tuple(x[idx] for x in data))
                updates, opt_state = tx_j.update(grads, opt_state)
                params = optax.apply_updates(params, updates)
                losses.append(float(loss))

    pstate = _port_state(tpol)
    t_traj = tppo.Trajectory(*map(_t, traj))
    loss = tx._update(pstate, t_traj, _t(last), _perms=perms)["loss"]
    _rel(loss, np.mean(losses))
    want = interop.policy_from_numpy(_np_tree(params))
    for name, p in tpol.named_parameters():
        _rel(p, want[name].numpy(), atol=1e-15)


# ---------------------------------------------------------------------------
# collect against JAX
# ---------------------------------------------------------------------------


def _sharp(params, tpol):
    """log_std at -30 in both policies: actions equal the mean to ~1e-13."""
    p = jax.tree.map(lambda x: x, params)
    p["params"]["log_std"] = jnp.full_like(p["params"]["log_std"], -30.0)
    with torch.no_grad():
        tpol.log_std.fill_(-30.0)
    return p


def _collect_both(cfg_j, jp, cfg_t, tp, poses, jpol, params, tpol, midx=None,
                  opp_j=None, opp_t=None):
    jx, tx = _ppo_pair(cfg_j, jp, cfg_t, tp, jpol, tpol, opp_j, opp_t)
    params = _sharp(params, tpol)
    keys = jax.random.split(jax.random.PRNGKey(0), E)
    jmi = None if midx is None else jnp.asarray(midx)
    js, jo, *_ = jrollout.batched_reset(cfg_j, jp, jnp.asarray(poses), keys, map_idx=jmi)
    gen = torch.Generator().manual_seed(0)
    ts, to, *_ = trollout.batched_reset(cfg_t, tp, _t(poses), gen,
                                        map_idx=None if midx is None else _t(midx))
    with fnn.intercept_methods(_f64_heads):
        js2, jo2, jtraj = jax.jit(lambda ps, s, o, ep: jx.collect(ps, s, o, ep))(
            jppo.PPOState(params, None, jax.random.PRNGKey(1)), js, jo, jp)
    ts2, to2, ttraj = tx.collect(_port_state(tpol), ts, to)
    return (js2, jo2, jtraj), (ts2, to2, ttraj)


def _check_dones(jtraj, ttraj):
    jd = np.asarray(jtraj[6])
    np.testing.assert_array_equal(ttraj.dones.numpy(), jd)
    per_env = jd.sum(0)
    assert (per_env > 0).any() and (per_env == 0).any(), per_env
    assert jd[1:-1].any(), "no env done within the rollout"


def _check_exact(j, t):
    (js2, jo2, jtraj), (ts2, to2, ttraj) = j, t
    _check_dones(jtraj, ttraj)
    for k, name in ((0, "feats"), (1, "vels"), (4, "values"), (5, "rewards")):
        np.testing.assert_allclose(getattr(ttraj, name).numpy(), np.asarray(jtraj[k]),
                                   rtol=0, atol=1e-9, err_msg=name)
    np.testing.assert_allclose(ttraj.acts.numpy(), np.asarray(jtraj[2]), rtol=0, atol=1e-9)
    np.testing.assert_allclose(ts2.x.numpy(), np.asarray(js2.x), rtol=0, atol=1e-9)
    np.testing.assert_allclose(to2.scans.numpy(), np.asarray(jo2.scans), rtol=0, atol=1e-9)
    for f in ("collisions", "lap_counts", "toggle_list", "step_idx"):
        np.testing.assert_array_equal(getattr(ts2, f).numpy(), np.asarray(getattr(js2, f)),
                                      err_msg=f)


@pytest.mark.parametrize("opponents", ["cruise", "self"])
def test_collect_exact_float64_matches_jax(exact64, opponents):
    cfg_j, jp, cfg_t, tp, poses = exact64
    jpol, params, tpol = _policies()
    opp = None if opponents == "cruise" else "self"
    j, t = _collect_both(cfg_j, jp, cfg_t, tp, poses, jpol, params, tpol, opp_j=opp,
                         opp_t=opp)
    _check_exact(j, t)


def test_collect_multimap_pursuit_matches_jax():
    """Exact scan, float64, on [track_0019, track_0042] stacked, envs
    alternating between them, opponents on pure_pursuit_opponents_multi."""
    tracks = ["track_0019", "track_0042"]
    yamls = [assets.named_map_yaml(n) for n in tracks]
    cfg_j, cfg_t = JSimConfig(**EXACT_KW), TSimConfig(**EXACT_KW)
    jp = jenv.make_multimap_params(cfg_j, yamls)
    tp = interop.params_from_numpy(cfg_t, _leaves(jp.vehicle), _leaves(jp.tables),
                                   _leaves(jp.tmap), None, device="cpu")
    midx = (np.arange(E) % 2).astype(np.int32)
    table = assets.start_pose_table(tracks, A)
    poses = table[midx].copy()
    poses[2:4, 0, 2] += np.pi / 2      # two envs face a wall
    jppp = jpp.stack_params([jpp.make_params(jpp.load_waypoints_csv(
        assets.waypoints_csv(n), dtype=jnp.float64)) for n in tracks])
    tppp = interop.pure_pursuit_from_numpy(_leaves(jppp), device="cpu")
    jpol, params, tpol = _policies()
    j, t = _collect_both(cfg_j, jp, cfg_t, tp, poses, jpol, params, tpol, midx=midx,
                         opp_j=jppo.pure_pursuit_opponents_multi(jppp),
                         opp_t=tppo.pure_pursuit_opponents_multi(tppp))
    _check_exact(j, t)
    assert torch.equal(t[0].map_idx, _t(midx))
    # the opponents drove forward along their own raceline
    lines = tppp.waypoints[_t(midx).long(), :, :2]
    _, d0, _, i0 = tpp.nearest_point(_t(poses[:, 1, 0]), _t(poses[:, 1, 1]), lines)
    _, d1, _, i1 = tpp.nearest_point(t[0].x[:, 1, 0], t[0].x[:, 1, 1], lines)
    assert (d0 < 0.5).all() and (d1 < 0.5).all(), (d0, d1)
    assert (i1 > i0).all(), (i0, i1)

    # the hook alone, on the same observation: per-track racelines
    rng = np.random.default_rng(8)
    jo, to = _obs_pair(rng)
    xy = table[midx][:, :, :2] + rng.normal(0.0, 0.5, (E, A, 2))
    jo = jo._replace(poses_x=jnp.asarray(xy[..., 0]), poses_y=jnp.asarray(xy[..., 1]))
    to = to._replace(poses_x=_t(xy[..., 0]), poses_y=_t(xy[..., 1]))
    jc = jppo.pure_pursuit_opponents_multi(jppp)(jo, jnp.asarray(midx))
    tc = tppo.pure_pursuit_opponents_multi(tppp)(to, _t(midx))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="needs map_idx"):
        tppo.pure_pursuit_opponents_multi(tppp)(to, None)


def test_collect_bilinear_float32_matches_jax(tmp_path, monkeypatch):
    """The trainer's scan config in float32: kernel 4's twin against JAX's
    interpret-mode kernel 4 through a whole rollout."""
    monkeypatch.setenv("RED_GYM_TPU_TEXTURE_CACHE", str(tmp_path))
    cfg_j, cfg_t = JSimConfig(**BILINEAR_KW), TSimConfig(**BILINEAR_KW)
    jp = jenv.make_params(cfg_j, assets.named_map_yaml(TRACK))
    tp = interop.params_from_numpy(cfg_t, _leaves(jp.vehicle), _leaves(jp.tables),
                                   _leaves(jp.tmap), _leaves(jp.rtex), device="cpu")
    poses = _poses_along(TRACK)
    jpol, params, tpol = _policies(num_beams=cfg_t.num_beams, dtype="float32")
    (js2, jo2, jtraj), (ts2, to2, ttraj) = _collect_both(
        cfg_j, jp, cfg_t, tp, poses.astype(np.float32), jpol, params, tpol)
    _check_dones(jtraj, ttraj)
    np.testing.assert_array_equal(ts2.collisions.numpy(), np.asarray(js2.collisions))
    cell = float(tp.rtex.cell)
    for got, want in ((to2.scans, jo2.scans),
                      (torch.expm1(ttraj.feats), np.expm1(np.asarray(jtraj[0])))):
        err = np.abs(got.numpy().astype(np.float64) - np.asarray(want, np.float64))
        assert np.quantile(err, 0.99) < 1e-3, np.quantile(err, 0.99)
        assert np.mean(err > 4 * cell) < 2e-3, np.mean(err > 4 * cell)
    np.testing.assert_allclose(ts2.x[..., [0, 1, 4]].numpy(),
                               np.asarray(js2.x)[..., [0, 1, 4]], rtol=0, atol=1e-4)


def _poses_along(track):
    """(E, A, 3) start poses: env e's cars at waypoint rows 40 e and 40 e + 8,
    heading along the raceline; the odd envs' ego turned to face the
    track's left wall."""
    w = np.loadtxt(assets.waypoints_csv(track), delimiter=";", comments="#")
    poses = np.zeros((E, A, 3))
    for e in range(E):
        for a in range(A):
            r = 40 * e + 8 * a
            poses[e, a] = w[r, 1], w[r, 2], np.arctan2(w[r + 1, 2] - w[r, 2],
                                                       w[r + 1, 1] - w[r, 1])
        if e % 2:
            poses[e, 0, 2] += np.pi / 2
    return poses


# ---------------------------------------------------------------------------
# the port's own trainer properties
# ---------------------------------------------------------------------------


def _small_trainer(reward_fn=None, dtype="float32"):
    cfg = TSimConfig(**dict(EXACT_KW, dtype=dtype, scan_noise_std=0.01))
    params = tenv.make_params(cfg, assets.named_map_yaml(TRACK), device="cpu")
    ppo = tppo.PPO(cfg, params, tppo.PPOConfig(rollout_len=4, minibatches=2, epochs=1),
                   tppo.ScanPolicy(B, HIDDEN, scan_stride=STRIDE), reward_fn=reward_fn)
    poses = torch.as_tensor(_poses_along(TRACK), dtype=cfg.tdtype)
    state, obs, *_ = trollout.batched_reset(cfg, params, poses,
                                            torch.Generator().manual_seed(0))
    return ppo, state, obs


def test_train_step_updates_params_and_reports_metrics():
    ppo, state, obs = _small_trainer()
    pstate = ppo.init(torch.Generator().manual_seed(1))
    before = {k: v.clone() for k, v in pstate.policy.state_dict().items()}
    pstate2, state2, obs2, metrics = ppo.train_step(pstate, state, obs)
    assert set(metrics) == {"loss", "reward_mean", "done_rate", "speed_mean",
                            "reset_steps", *tppo.DIAGNOSTICS}
    assert all(isinstance(v, torch.Tensor) for v in metrics.values())
    assert np.isfinite(float(metrics["loss"]))
    after = pstate2.policy.state_dict()
    assert any(not torch.equal(before[k], after[k]) for k in before), "no parameter moved"
    assert int(state2.step_idx.min()) > 0


def test_custom_reward_fn_changes_learning_signal():
    """A constant reward gives reward_mean 1; the default shaping does not."""
    def constant_reward(cfg, o, o2):
        return torch.ones_like(o2.linear_vels_x[:, cfg.ego_idx])

    got = {}
    for name, fn in (("default", None), ("const", constant_reward)):
        ppo, state, obs = _small_trainer(reward_fn=fn)
        pstate = ppo.init(torch.Generator().manual_seed(1))
        got[name] = float(ppo.train_step(pstate, state, obs)[3]["reward_mean"])
    assert got["const"] == pytest.approx(1.0)
    assert got["default"] != pytest.approx(1.0)


def test_pursuit_opponents_move_along_track():
    ppo, state, obs = _small_trainer()
    wpts = tpp.load_waypoints_csv(assets.waypoints_csv(TRACK), dtype=torch.float32,
                                  device="cpu")
    hook = tppo.pure_pursuit_opponents(tpp.make_params(wpts))
    ctrl = hook(obs)
    assert ctrl.shape == (E, A, 2) and torch.isfinite(ctrl).all()
    ppo = tppo.PPO(ppo.cfg, ppo.env_params, ppo.pcfg, ppo.policy, opponent_plan=hook)
    pstate = ppo.init(torch.Generator().manual_seed(1))
    _, state2, obs2, _ = ppo.train_step(pstate, state, obs)
    moved = torch.hypot(obs2.poses_x[:, 1] - obs.poses_x[:, 1],
                        obs2.poses_y[:, 1] - obs.poses_y[:, 1])
    assert (moved > 1e-3).all()
    assert not (obs2.collisions[:, 1] > 0).any()


def test_opponent_hook_arity_and_policy_width():
    ppo, state, obs = _small_trainer()
    seen = []

    def old_hook(o):
        seen.append("old")
        return torch.zeros(o.poses_x.shape + (2,))

    def new_hook(o, map_idx):
        seen.append(map_idx)
        return torch.zeros(o.poses_x.shape + (2,))

    for hook in (old_hook, new_hook):
        p = tppo.PPO(ppo.cfg, ppo.env_params, ppo.pcfg, ppo.policy, opponent_plan=hook)
        p._env_actions(torch.zeros(E, 2), obs)
    assert seen == ["old", None]
    with pytest.raises(ValueError, match="beams"):
        tppo.PPO(ppo.cfg, ppo.env_params, policy=tppo.ScanPolicy(B + 1))


def test_checkpoint_round_trips_and_resumes(tmp_path):
    """PPOState, EnvState and Observation restore bit for bit into a
    template; a run resumed from the checkpoint equals the run continued."""
    ppo, state, obs = _small_trainer()
    pstate = ppo.init(torch.Generator().manual_seed(1))
    pstate, state, obs, _ = ppo.train_step(pstate, state, obs)
    path = checkpoint.save(str(tmp_path / "ckpt.pt"), {"pstate": pstate, "state": state,
                                                       "obs": obs}, step=1)
    with pytest.raises(FileExistsError):
        checkpoint.save(path, state, overwrite=False)
    plain = checkpoint.restore(path)
    assert set(plain) == {"pstate", "state", "obs"} and isinstance(plain["state"], dict)

    # continue
    cont = ppo.train_step(pstate, state, obs)
    # resume into a fresh trainer of another seed
    like = {"pstate": ppo.init(torch.Generator().manual_seed(99)), "state": state,
            "obs": obs}
    got = checkpoint.restore(path, like=like)
    assert isinstance(got["state"], tenv.EnvState)
    assert isinstance(got["obs"], tenv.Observation)
    for a, b in zip(got["state"], plain["state"].values()):
        assert (a is None and b is None) or torch.equal(a, b)
    res = ppo.train_step(got["pstate"], got["state"], got["obs"])
    for k, v in cont[0].policy.state_dict().items():
        assert torch.equal(v, res[0].policy.state_dict()[k]), k
    for a, b in zip(cont[1], res[1]):
        assert (a is None and b is None) or torch.equal(a, b)
    for k in cont[3]:
        assert torch.equal(cont[3][k], res[3][k]), k
    assert torch.equal(cont[0].gen.get_state(), res[0].gen.get_state())
    opt_a, opt_b = cont[0].optimizer.state_dict(), res[0].optimizer.state_dict()
    for i, s in opt_a["state"].items():
        for k, v in s.items():
            assert torch.equal(v, opt_b["state"][i][k])


def test_train_ppo_cli_runs_on_cpu(tmp_path):
    """train_ppo --device cpu writes its CSV and checkpoint; --eval reads it."""
    csv, ckpt = tmp_path / "curve.csv", tmp_path / "ckpt.pt"
    env = dict(os.environ, RED_GYM_TPU_TEXTURE_CACHE="off")
    base = [sys.executable, "-m", "red_gym_tpu_torch.examples.train_ppo", "--device", "cpu",
            "--envs", "8", "--beams", "64", "--rollout", "4", "--scan-mode", "exact",
            "--save", str(ckpt)]
    out = subprocess.run(base + ["--iters", "2", "--log-csv", str(csv)], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = csv.read_text().splitlines()
    assert lines[0] == ("iter,env_steps,loss,reward_mean,done_rate,speed_mean,wall_s,"
                        "approx_kl,clip_frac,log_std_0,log_std_1,value_loss,grad_norm")
    assert len(lines) == 3 and lines[2].startswith("1,64,")
    assert "iter 1: loss=" in out.stdout and ckpt.exists()
    out = subprocess.run(base + ["--eval", "--eval-steps", "5"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "restored trainer state" in out.stdout and "crash rate" in out.stdout
