"""The port's PPO learning held to JAX's over the trainer's own paths: the
multi-map collect of ``examples/train_ppo.py --multi-map`` (bilinear fast
scan, edge + grad channels, float32, kernel 4) and several ``train_step``s
in a row, which carry the env state, the observation, Adam's moments and
the policy from one iteration to the next.

Both packages run on the CPU from the same numpy inputs; the policy's
weights are carried across with ``interop.policy_from_numpy``.  Where a
package draws at random, the test injects one numpy slab into both: the
port's action noise through ``agents.ppo.draws.draw_rows`` and its
permutations through ``agents.ppo.epoch_permutation``; JAX's through a
stand-in for the ``jax`` name of ``red_gym_tpu/agents/ppo.py``, whose
``random.normal`` and ``random.permutation`` look the key they are given up
in the chain of keys that JAX's ``collect`` and ``train_step`` split, and
return that key's row of the slab.  Nothing in the JAX package changes.

Bars.  The collect in float32: the scan bar of
``tests/test_scan_fast.py:890-896`` (p99 |diff| < 1e-3 m, fewer than 0.2 %
of beams off by more than 4 texture cells of the env's map) on the final
scans and the stored features, poses within 1e-4 m, dones and collisions
equal.  Three ``train_step``s in float64 on the exact scan: every
parameter, both Adam moments, the env state, the final scans, the four
metrics and GAE's inputs and outputs within relative 1e-10 (each field
also absolute 1e-12, for the entries that are 0 in one package and
round-off in the other); dones, collisions, laps and maps equal.  One
metric cannot be held that close: ``reward_mean`` averages the float32
rewards that both packages store, and JAX sums them in float32, so its
value carries float32 rounding (7e-8 relative measured): relative 1e-6
there, while the rewards themselves are held at 1e-10.  The
update's diagnostics against JAX's own arithmetic on one update: relative
1e-10.
"""

import types

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
from red_gym_tpu.config import SimConfig as JSimConfig
from red_gym_tpu_torch import assets, env as tenv, interop, rollout as trollout
from red_gym_tpu_torch.agents import ppo as tppo
from red_gym_tpu_torch.config import SimConfig as TSimConfig
from tests.test_torch_ppo import (A, BILINEAR_KW, EXACT_KW, STRIDE, _f64_heads,
                                  _np_tree, _policies, _sharp, _t, _traj)

TRACKS = ["track_0019", "track_0042"]
E = 8
MIDX = (np.arange(E) % len(TRACKS)).astype(np.int32)
RTOL, ATOL = 1e-10, 1e-12
# reward_mean is a mean of float32 rewards (both packages store them so),
# which JAX sums in float32: its rounding, not a difference of the rewards
REWARD_RTOL = 1e-6
ITERS = 3
T = 32
PCFG = dict(rollout_len=T, minibatches=2, epochs=2)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _yamls():
    return [assets.named_map_yaml(n) for n in TRACKS]


def _table():
    return assets.start_pose_table(TRACKS, A)


def _rel(got, want, name, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=name)


# ---------------------------------------------------------------------------
# collect at the trainer's multi-map scan config
# ---------------------------------------------------------------------------


def _recording_resets(monkeypatch):
    """Record, at every ``rollout.reset_done`` the port's collect makes,
    the done envs and the state it hands back."""
    seen = []
    inner = trollout.reset_done

    def reset_done(cfg, params, state, obs, done, *a, **k):
        out = inner(cfg, params, state, obs, done, *a, **k)
        seen.append((torch.nonzero(done).squeeze(1), out[0]))
        return out

    monkeypatch.setattr(trollout, "reset_done", reset_done)
    return seen


def test_multimap_collect_bilinear_float32_matches_jax(tmp_path, monkeypatch):
    """``collect`` on two packaged tracks stacked by each package's own
    ``make_multimap_params``, env e on map e % 2, cars on
    ``assets.start_pose_table`` (the trainer's start recipe).  The policy's
    mean head asks for full lock at about 7 m/s and the iTTC horizon is 2
    s, so every car meets a wall inside the rollout and ``reset_done``
    restarts it under ``map_idx``.  The port runs kernel 4's twin, JAX its
    interpret-mode kernel 4."""
    monkeypatch.setenv("RED_GYM_TPU_TEXTURE_CACHE", str(tmp_path))
    kw = dict(BILINEAR_KW, ttc_thresh=2.0)
    cfg_j, cfg_t = JSimConfig(**kw), TSimConfig(**kw)
    jp = jenv.make_multimap_params(cfg_j, _yamls())
    tp = tenv.make_multimap_params(cfg_t, _yamls(), device="cpu")
    assert tp.rtex.rt.shape[0] == len(TRACKS)
    table = _table()
    poses = table[MIDX].astype(np.float32)
    jpol, params, tpol = _policies(num_beams=cfg_t.num_beams, dtype="float32")
    # full left lock and about 7 m/s
    params = jax.tree.map(lambda x: x, params)
    params["params"]["Dense_2"]["bias"] = jnp.asarray([3.0, 2.0], jnp.float32)
    tpol.load_state_dict(interop.policy_from_numpy(_np_tree(params)))
    params = _sharp(params, tpol)
    jx = jppo.PPO(cfg_j, jp, jppo.PPOConfig(**PCFG), policy=jpol)
    tx = tppo.PPO(cfg_t, tp, tppo.PPOConfig(**PCFG), policy=tpol)

    keys = jax.random.split(jax.random.PRNGKey(0), E)
    js, jo, *_ = jrollout.batched_reset(cfg_j, jp, jnp.asarray(poses), keys,
                                        map_idx=jnp.asarray(MIDX))
    ts, to, *_ = trollout.batched_reset(cfg_t, tp, _t(poses), torch.Generator().manual_seed(0),
                                        map_idx=_t(MIDX))
    with fnn.intercept_methods(_f64_heads):
        js2, jo2, jtraj = jax.jit(lambda ps, s, o, ep: jx.collect(ps, s, o, ep))(
            jppo.PPOState(params, None, jax.random.PRNGKey(1)), js, jo, jp)
    seen = _recording_resets(monkeypatch)
    ts2, to2, ttraj = tx.collect(tppo.PPOState(tpol, None, torch.Generator().manual_seed(0)),
                                 ts, to)

    jd = np.asarray(jtraj[6])
    np.testing.assert_array_equal(ttraj.dones.numpy(), jd)
    assert jd[1:-1].any(), "no env done inside the rollout"
    assert set(MIDX[jd.any(0) > 0]) == {0, 1}, "a map without a restart"
    np.testing.assert_array_equal(ts2.collisions.numpy(), np.asarray(js2.collisions))
    np.testing.assert_array_equal(ts2.map_idx.numpy(), MIDX)
    np.testing.assert_array_equal(np.asarray(js2.map_idx), MIDX)
    cell = tp.rtex.cell.numpy()[MIDX][:, None, None]
    for got, want, name in ((to2.scans, jo2.scans, "scans"),
                            (torch.expm1(ttraj.feats), np.expm1(np.asarray(jtraj[0])),
                             "feats")):
        err = np.abs(got.numpy().astype(np.float64) - np.asarray(want, np.float64))
        c = cell if name == "scans" else cell[None, :, :, 0]
        assert np.quantile(err, 0.99) < 1e-3, (name, np.quantile(err, 0.99))
        assert np.mean(err > 4 * c) < 2e-3, (name, np.mean(err > 4 * c))
    np.testing.assert_allclose(ts2.x[..., [0, 1, 4]].numpy(),
                               np.asarray(js2.x)[..., [0, 1, 4]], rtol=0, atol=1e-4)

    # every restarted env stands on its own map's row of the start table
    assert sum(idx.numel() for idx, _ in seen) == int(jd.sum())
    for idx, state in seen:
        m = state.map_idx[idx].long()
        assert torch.equal(m, _t(MIDX)[idx].long())
        want = torch.as_tensor(table, dtype=torch.float32)[m]
        assert torch.equal(state.start_pose[idx], want)
        assert torch.equal(state.x[idx][..., [0, 1, 4]], want)
        assert torch.equal(state.x[idx][..., 3], torch.zeros_like(want[..., 0]))


# ---------------------------------------------------------------------------
# three train_steps in a row, float64, exact scan
# ---------------------------------------------------------------------------


class _JaxDraws:
    """A stand-in for the ``jax`` name of JAX's ppo module: ``random.normal``
    and ``random.permutation`` return the slab row of the key they are
    given, its row in ``noise_keys`` or ``perm_keys`` (K, 2); all else is
    jax itself."""

    def __init__(self, noise_keys, noise, perm_keys, perms):
        def lookup(keys, key):
            hit = jnp.all(keys == jax.random.key_data(key)[None], axis=1)
            return jnp.argmax(hit)

        nk, pk = jnp.asarray(noise_keys), jnp.asarray(perm_keys)
        noise, perms = jnp.asarray(noise), jnp.asarray(perms)
        rnd = types.SimpleNamespace(
            **{k: getattr(jax.random, k) for k in dir(jax.random) if not k.startswith("_")})
        rnd.normal = lambda key, shape, *a, **k: noise[lookup(nk, key)].reshape(shape)
        rnd.permutation = lambda key, n, *a, **k: perms[lookup(pk, key)][:n]
        self.random = rnd

    def __getattr__(self, name):
        return getattr(jax, name)


def _key_chains(key0, iters, steps, epochs):
    """The keys JAX's train_step splits, iteration after iteration, as its
    code splits them: each step's action key (``collect``) and each epoch's
    permutation key, both chains starting from the state's key -> (the
    distinct action keys in the order they are first used, the permutation
    keys)."""
    ka, kp, key = [], [], key0
    for _ in range(iters):
        k = key
        for _ in range(steps):
            k, a, _ = jax.random.split(k, 3)
            ka.append(tuple(np.asarray(jax.random.key_data(a)).tolist()))
        k = key
        for _ in range(epochs):
            k, p = jax.random.split(k)
            kp.append(np.asarray(jax.random.key_data(p)))
        key = k
    return np.array(list(dict.fromkeys(ka)), np.uint32), np.stack(kp)


def _slab_draws(monkeypatch, noise, perms):
    """The port's action noise and permutations, row after row."""
    rows = iter(torch.from_numpy(noise))
    orders = iter(torch.from_numpy(perms))
    real = tppo.draws

    class Draws(types.ModuleType):
        def __getattr__(self, name):
            return getattr(real, name)

    stub = Draws("draws")
    stub.draw_rows = lambda n, fn: next(rows)
    monkeypatch.setattr(tppo, "draws", stub)
    monkeypatch.setattr(tppo, "epoch_permutation", lambda n, gen, device: next(orders))


def _recording_gae(obj):
    """Wrap ``obj._gae`` to keep its inputs (values, rewards, dones, last
    value) and outputs (advantages, returns) -> the list they go to."""
    kept, inner = [], obj._gae

    def gae(*a):
        out = inner(*a)
        kept.append(tuple(a) + tuple(out))
        return out

    obj._gae = gae
    return kept


def test_three_train_steps_float64_match_jax(monkeypatch):
    """Three train_steps of 32 steps on [track_0019, track_0042] stacked,
    env e on map e % 2, opponents cruising; envs 2, 3, 6 and 7 start (and
    so restart) facing a wall, so every rollout restarts some env on both
    maps.  The policy keeps a real ``log_std`` (-0.3, -0.7): the actions
    are the mean plus the injected noise.  After each iteration the
    parameters, Adam's moments and step, the env state, the observation,
    the four metrics and GAE's advantages and returns agree."""
    cfg_j, cfg_t = JSimConfig(**EXACT_KW), TSimConfig(**EXACT_KW)
    jp = jenv.make_multimap_params(cfg_j, _yamls())
    tp = tenv.make_multimap_params(cfg_t, _yamls(), device="cpu")
    poses = _table()[MIDX].copy()
    poses[[2, 3, 6, 7], 0, 2] += np.pi / 2
    jpol, params, tpol = _policies()
    params = jax.tree.map(lambda x: x, params)
    params["params"]["log_std"] = jnp.asarray([-0.3, -0.7])
    tpol.load_state_dict(interop.policy_from_numpy(_np_tree(params)))

    key0 = jax.random.PRNGKey(5)
    ka, kp = _key_chains(key0, ITERS, T, PCFG["epochs"])
    # JAX's train_step splits its state's key for collect and again for the
    # epochs, and split(k, n)[j] does not depend on n: the key it returns is
    # collect's after `epochs` steps, so each iteration after the first
    # draws action noise for only its last `epochs` steps (fault C3)
    assert len(ka) == T + PCFG["epochs"] * (ITERS - 1), len(ka)
    rng = np.random.default_rng(11)
    n = T * E
    # rows for a fresh draw at every step, so that a port which draws more
    # noise than JAX fails on the trajectories, not on the slab's end
    noise = rng.standard_normal((ITERS * T, E, 2))
    perms = np.stack([rng.permutation(n) for _ in range(ITERS * PCFG["epochs"])])
    monkeypatch.setattr(jppo, "jax", _JaxDraws(ka, noise, kp, perms))
    _slab_draws(monkeypatch, noise, perms)

    jx = jppo.PPO(cfg_j, jp, jppo.PPOConfig(**PCFG), policy=jpol)
    tx = tppo.PPO(cfg_t, tp, tppo.PPOConfig(**PCFG), policy=tpol)
    jgae, tgae = _recording_gae(jx), _recording_gae(tx)

    keys = jax.random.split(jax.random.PRNGKey(0), E)
    js, jo, *_ = jrollout.batched_reset(cfg_j, jp, jnp.asarray(poses), keys,
                                        map_idx=jnp.asarray(MIDX))
    ts, to, *_ = trollout.batched_reset(cfg_t, tp, _t(poses), torch.Generator().manual_seed(0),
                                        map_idx=_t(MIDX))
    jstate = jppo.PPOState(params, jx.tx.init(params), key0)
    opt = torch.optim.Adam(tpol.parameters(), lr=3e-4, betas=(0.9, 0.999), eps=1e-8)
    tstate = tppo.PPOState(tpol, opt, torch.Generator().manual_seed(0))

    def jax_iter(ps, s, o, ep):
        out = jx.train_step(ps, s, o, ep)
        return out, jgae.pop()

    step_j = jax.jit(jax_iter)
    for it in range(ITERS):
        with fnn.intercept_methods(_f64_heads):
            (jstate, js, jo, jm), jgae_out = step_j(jstate, js, jo, jp)
        tstate, ts, to, tm = tx.train_step(tstate, ts, to)
        tag = f"iteration {it}"
        for name, got, want in zip(("values", "rewards", "dones", "last value",
                                    "advantages", "returns"), tgae.pop(), jgae_out):
            _rel(got, want, f"{tag}: {name}")
        for k in ("loss", "done_rate", "speed_mean"):
            _rel(tm[k], jm[k], f"{tag}: {k}")
        # both store the rewards in float32, and JAX sums them in float32
        _rel(tm["reward_mean"], jm["reward_mean"], f"{tag}: reward_mean", rtol=REWARD_RTOL)
        assert float(tm["done_rate"]) > 0, f"{tag}: no env restarted"

        want = interop.policy_from_numpy(_np_tree(jstate.params))
        adam = jstate.opt_state[0]
        mu = interop.policy_from_numpy(_np_tree(adam.mu))
        nu = interop.policy_from_numpy(_np_tree(adam.nu))
        for name, p in tpol.named_parameters():
            _rel(p, want[name].numpy(), f"{tag}: {name}")
            st = opt.state[p]
            _rel(st["exp_avg"], mu[name].numpy(), f"{tag}: Adam mu of {name}")
            _rel(st["exp_avg_sq"], nu[name].numpy(), f"{tag}: Adam nu of {name}")
            assert int(st["step"]) == int(adam.count) == (it + 1) * 4

        _rel(ts.x, js.x, f"{tag}: x")
        _rel(to.scans, jo.scans, f"{tag}: scans")
        for f in ("collisions", "lap_counts", "toggle_list", "near_starts", "map_idx"):
            np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                          err_msg=f"{tag}: {f}")
        _rel(ts.start_pose, js.start_pose, f"{tag}: start_pose")
        _rel(ts.steer_buf, js.steer_buf, f"{tag}: steer_buf")
        # every restart went back to the env's own start on its own map
        np.testing.assert_array_equal(np.asarray(js.start_pose), poses)


def test_update_diagnostics_match_jax():
    """One update of 2 epochs x 2 minibatches with fixed permutations: the
    port's diagnostics equal the same statistics computed with JAX's policy
    and loss over JAX's own steps: the mean over the minibatches of the
    approximate KL (r - 1) - log r, the share of |r - 1| > clip_eps, the
    value term and optax's global norm of the gradient; log_std after the
    update."""
    cfg_j, cfg_t = JSimConfig(**EXACT_KW), TSimConfig(**EXACT_KW)
    jpol, params, tpol = _policies()
    jx = jppo.PPO(cfg_j, None, jppo.PPOConfig(**PCFG), policy=jpol)
    tx = tppo.PPO.__new__(tppo.PPO)
    tx.pcfg, tx.mesh, tx._feat_stride = tppo.PPOConfig(**PCFG), None, STRIDE
    rng = np.random.default_rng(12)
    n_t = 4
    traj = _traj(rng, (EXACT_KW["num_beams"] + STRIDE - 1) // STRIDE, n_t)
    last = rng.normal(0, 1, (E,))
    feats, vels, acts, logps, values, rewards, dones = map(jnp.asarray, traj)
    adv, returns = jx._gae(values, rewards, dones, jnp.asarray(last))
    n = n_t * E
    flat = lambda x: x.reshape((n,) + x.shape[2:])  # noqa: E731
    data = tuple(map(flat, (feats, vels, acts, logps, adv, returns)))
    opt_j = optax.adam(3e-4)
    opt_state = opt_j.init(params)
    perms = [rng.permutation(n) for _ in range(2)]
    mb = n // 2
    got = {k: [] for k in ("loss", "value_loss", "approx_kl", "clip_frac", "grad_norm")}
    with fnn.intercept_methods(_f64_heads):
        for perm in perms:
            for i in range(2):
                batch = tuple(x[perm[i * mb:(i + 1) * mb]] for x in data)
                (loss, aux), grads = jax.value_and_grad(jx._loss, has_aux=True)(params, batch)
                mean, log_std, _ = jx._apply(params, batch[0], batch[1])
                log_r = jppo.gaussian_logp(mean, log_std, batch[2]) - batch[3]
                r = jnp.exp(log_r)
                got["loss"].append(loss)
                got["value_loss"].append(aux["vf"])
                got["approx_kl"].append(jnp.mean((r - 1) - log_r))
                got["clip_frac"].append(jnp.mean(jnp.abs(r - 1) > 0.2))
                got["grad_norm"].append(optax.global_norm(grads))
                updates, opt_state = opt_j.update(grads, opt_state)
                params = optax.apply_updates(params, updates)
    assert 0 < np.mean(got["clip_frac"]) < 1, got["clip_frac"]

    pstate = tppo.PPOState(tpol, torch.optim.Adam(tpol.parameters(), lr=3e-4,
                                                  betas=(0.9, 0.999), eps=1e-8), None)
    stats = tx._update(pstate, tppo.Trajectory(*map(_t, traj)), _t(last),
                       _perms=[_t(p) for p in perms])
    assert set(stats) == set(got)
    for k, v in got.items():
        _rel(stats[k], np.mean(v), k)
    _rel(tpol.log_std, params["params"]["log_std"], "log_std")
