"""The port's SAC trainers held to JAX's over whole iterations: select
action, env step, replay push, restart of the done envs, updates, and
several iterations in a row, which carry the replay, the three Adams, the
target critics and the env (or plan) state.  Also the lap logic on driven
start-line crossings.

The JAX side is ``learning_ab.py``'s statement-for-statement copy of the
trainer bodies of ``examples/train_sac_scale.py`` and
``examples/train_sac_bitmap_scale.py``; the port's side is
``red_gym_tpu_torch.examples.train_sac_scale`` and
``train_sac_bitmap_scale`` (``build`` and ``iteration``).  Both run on the
CPU from the same numpy inputs; the SAC weights come across with
``interop.sac_from_numpy``.

The draws.  JAX threefry and torch Philox never match, so one numpy slab
feeds both packages:

- the policy's eps and the update's two normal draws, the replay indices
  and the warm-up's uniform actions: the port's ``agents.sac.normal_draw``,
  ``agents.sac.replay_indices`` and ``train_sac_bitmap_scale.uniform_actions``
  hand out the slab's rows in the order the port calls them; JAX's through a
  stand-in for the ``jax`` name of ``red_gym_tpu/agents/sac.py`` and for the
  trainer copies' draw source, whose ``random.normal``, ``random.randint``
  and ``random.uniform`` look the key they are given up among the keys that
  JAX's trainer chain makes (``split(key, 5)`` a step, ``fold_in(kb, j)``,
  ``fold_in(ku, j)`` and ``split`` inside ``SAC.update``), in the order of
  first use, and return that key's row.  A key that JAX's chain used twice
  would give JAX a row the port did not draw again (as fault C3 did in PPO);
  the test asserts first that the chain reuses none.
- the scan noise (``noise_mode="pool"``: a pool row a step an env, the
  pool carried across from JAX): JAX draws its picks from each env's own key
  chain and restarts an env from ``split(kr, E)[e]``; the port's picks come
  from a stand-in for ``env.draws`` that follows the same chains, knowing
  which envs ``reset_done`` restarts.  So each restart's noise is JAX's.

Nothing in the JAX package changes.

Tests and bars:

- ``test_scan_trainer_iteration_float32_matches_jax``: one iteration of the
  scan trainer at its config (spectral fast scan, float32, RK4, dt 0.01,
  a coarse texture of track_0019 at pose stride 16 built by each package),
  the port on kernel 5's twin and JAX on its interpret-mode kernel 5
  (``scan_backend="pallas", fuse_scan_ttc="on"``), an update after each
  step; four of eight cars face a wall and two restart inside the
  iteration.  The replay's observations and next observations at the
  float32 scan bar of ``tests/test_scan_fast.py:890-896`` (p99 |diff| <
  1e-3 m, fewer than 0.2 % of beams off by more than 4 texture cells;
  measured p99 1.9e-6 m, none); actions and rewards within 1e-4 (float32
  policies on those scans; measured 9e-7 and 7e-9); poses within 1e-4 m;
  dones, and so the restarted envs, exactly equal.
- ``test_three_scan_trainer_iterations_float64_match_jax`` and
  ``test_three_bitmap_trainer_iterations_float64_match_jax``: three
  iterations, ``warmup_iters=1`` and ``updates_per_step=2``, in float64 on
  the exact scan (the bitmap trainer through the float64 ``PlanningEnv``
  and the float64 CNN of ``tests/test_torch_sac.py``'s ``_f64_sac``), envs
  facing a wall so that they restart in every iteration, the replay
  wrapping around in the third.  After each iteration: the actor, both
  critics, both targets and the three Adams' moments and step; the replay's
  contents, ``ptr`` and ``size``; the env or plan state; within relative
  1e-8 (absolute 1e-10 for entries that are 0 in one package and round-off
  in the other); dones, bitmaps, collision flags and lap counters equal.
  The three metrics are sums of float32 values in float32 in both packages
  (``Metrics``): relative 1e-6, a few float32 ulps.
- ``test_lap_logic_on_driven_crossings_matches_jax``: ``_lap_done_update``
  of both packages along synthetic ego trajectories, three laps of the
  raceline of track_0101 and track_0019 at 8 m/s and 0.01 s steps, offset
  to the side by 0 to 3.2 m across the ±2.0 m finish band (whose reach at
  the line is 2.0 + sqrt(finish_dist2) = 2.316 m): lap counts, toggles,
  latches, lap times and done equal at every step; the study's lateral
  offset (``generalization_study.start_frame``) is the one driven.
"""

import argparse
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import learning_ab
from red_gym_tpu import env as jenv
from red_gym_tpu.agents import sac as jsac
from red_gym_tpu.config import Integrator as JIntegrator
from red_gym_tpu.config import SimConfig as JSimConfig
from red_gym_tpu_torch import assets, env as tenv, interop, rollout as trollout
from red_gym_tpu_torch.agents import planning_env as tpe
from red_gym_tpu_torch.agents import sac as tsac
from red_gym_tpu_torch.config import Integrator as TIntegrator
from red_gym_tpu_torch.config import SimConfig as TSimConfig
from red_gym_tpu_torch.examples import generalization_study
from red_gym_tpu_torch.examples import train_sac_bitmap_scale as tbm
from red_gym_tpu_torch.examples import train_sac_scale as tsc
from tests.test_torch_sac import _Float64Numpy

TRACK = "track_0019"
BEAMS = 108
RTOL, ATOL = 1e-8, 1e-10
# Metrics sums float32 values in float32 in both packages
METRIC_RTOL = 1e-6
ITERS = 3


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _rel(got, want, name, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float64), rtol=rtol, atol=atol,
                               err_msg=name)


def _wall_poses(envs: int, facing: dict) -> np.ndarray:
    """(E, 1, 3): track_0019's waypoint start; env e in ``facing`` moved
    |facing[e]| m to the left, toward the wall, and turned to face it (or,
    for a negative value, to turn its back to it)."""
    s = assets.waypoint_start_poses(assets.named_map_yaml(TRACK), 1)[0]
    poses = np.repeat(s[None, None], envs, axis=0)
    th = s[2] + np.pi / 2
    for e, d in facing.items():
        poses[e, 0] = [s[0] + abs(d) * np.cos(th), s[1] + abs(d) * np.sin(th),
                       th if d > 0 else th - np.pi]
    return poses


# ---------------------------------------------------------------------------
# the draws
# ---------------------------------------------------------------------------


def _kd(key) -> tuple:
    return tuple(np.asarray(jax.random.key_data(key)).tolist())


def _scale_chain(key0, iters, steps, updates, warmup, envs):
    """JAX's scan-trainer chain (train_sac_scale.py:91, :114-117 and
    SAC.update's split), step after step -> list of dicts: the action key,
    the replay keys, the update's (k_next, k_new) pairs, the restart keys."""
    key, out = key0, []
    for it in range(iters):
        for _ in range(steps):
            key, ka, kb, kr, ku = jax.random.split(key, 5)
            n = updates if it >= warmup else 0
            out.append(dict(
                ka=ka, kb=[jax.random.fold_in(kb, j) for j in range(n)],
                ku=[tuple(jax.random.split(jax.random.fold_in(ku, j))) for j in range(n)],
                rkeys=np.asarray(jax.random.split(kr, envs)), update=n > 0))
    return out


def _bitmap_chain(key0, iters, steps, updates, warmup, envs):
    """JAX's bitmap-trainer chain (train_sac_bitmap_scale.py:104-105, :123,
    :143-146) -> (the initial reset keys, the per-step dicts)."""
    key, kr = jax.random.split(key0)
    out = []
    for it in range(iters):
        for _ in range(steps):
            key, ka, kb, ku, kr2 = jax.random.split(key, 5)
            n = updates if it >= warmup else 0
            out.append(dict(
                ka=ka, kb=[jax.random.fold_in(kb, j) for j in range(n)],
                ku=[tuple(jax.random.split(jax.random.fold_in(ku, j))) for j in range(n)],
                rkeys=np.asarray(jax.random.split(kr2, envs)), update=n > 0))
    return np.asarray(jax.random.split(kr, envs)), out


class _Slabs:
    """One slab of each draw, the keys JAX uses for its rows, and the port's
    counters."""

    def __init__(self, chain, envs, batch, capacity, rng, action_dim, uniform_warmup):
        self.n_keys, self.i_keys, self.u_keys = [], [], []
        idx_rows, size = [], 0
        for st in chain:
            size = min(size + envs, capacity)
            (self.n_keys if st["update"] or not uniform_warmup else self.u_keys).append(
                _kd(st["ka"]))
            for kb, (kn, kw) in zip(st["kb"], st["ku"]):
                self.i_keys.append(_kd(kb))
                idx_rows.append(rng.integers(0, size, batch))
                self.n_keys += [_kd(kn), _kd(kw)]
        for name, keys in (("normal", self.n_keys), ("randint", self.i_keys),
                           ("uniform", self.u_keys)):
            assert len(set(keys)) == len(keys), f"JAX's chain reuses a {name} key"
        rows = max(envs, batch)
        self.normal = rng.standard_normal((len(self.n_keys), rows, action_dim))
        self.idx = np.stack(idx_rows) if idx_rows else np.zeros((0, batch), np.int64)
        self.uniform = rng.uniform(-1.0, 1.0, (max(len(self.u_keys), 1), envs,
                                               action_dim)).astype(np.float32)
        self.count = dict(normal=0, randint=0, uniform=0)
        self.uniform_dtype = jnp.float32

    def take(self, name):
        i = self.count[name]
        self.count[name] += 1
        return getattr(self, {"randint": "idx"}.get(name, name))[i]

    def jax_draws(self):
        """A stand-in for the ``jax`` name of JAX's sac module whose
        ``random`` also serves as the trainer copies' draw source."""
        def lookup(keys, key):
            hit = jnp.all(jnp.asarray(np.array(keys, np.uint32))
                          == jax.random.key_data(key)[None], axis=1)
            return jnp.argmax(hit)

        normal, idx, uniform = map(jnp.asarray, (self.normal, self.idx, self.uniform))
        rnd = types.SimpleNamespace(
            **{k: getattr(jax.random, k) for k in dir(jax.random) if not k.startswith("_")})

        def rnormal(key, shape, dtype=float):
            return normal[lookup(self.n_keys, key)][:shape[0], :shape[1]].astype(dtype)

        def rrandint(key, shape, minval, maxval, dtype=int):
            return idx[lookup(self.i_keys, key)][:shape[0]].astype(dtype)

        def runiform(key, shape, dtype=float, minval=0.0, maxval=1.0):
            # the float32 slab in the config's type: the bitmap trainer asks
            # for float32 actions, which its float64 planning env refuses
            row = uniform[lookup(self.u_keys, key)].reshape(shape)
            return row.astype(jnp.promote_types(dtype, self.uniform_dtype))

        rnd.normal, rnd.randint, rnd.uniform = rnormal, rrandint, runiform
        return _JaxProxy(rnd)

    def port_draws(self, monkeypatch):
        monkeypatch.setattr(tsac, "normal_draw", lambda shape, gen, dtype, device: torch.from_numpy(
            self.take("normal")[:shape[0], :shape[1]]).to(dtype))
        monkeypatch.setattr(tsac, "replay_indices", lambda size, b, gen, device: torch.from_numpy(
            self.take("randint")[:b]).long())
        monkeypatch.setattr(tbm, "uniform_actions", lambda n, gen, device: torch.from_numpy(
            self.take("uniform")[:n]))


class _JaxProxy:
    """``jax`` with its ``random`` replaced."""

    def __init__(self, random):
        self.random = random

    def __getattr__(self, name):
        return getattr(jax, name)


class _EnvChains:
    """The port's scan-noise picks from JAX's env key chains: env e's key
    starts at ``keys0[e]``, each step splits it into (next key, pick key)
    and picks ``randint(pick key, (), 0, rows)`` as ``red_gym_tpu/env.py``'s
    ``sim_step`` does; an env restarted at trainer step t starts again from
    ``restart_keys[t][e]``.  ``reset_done`` (wrapped by ``watch``) says which
    envs restart."""

    def __init__(self, keys0, rows: int, restart_keys):
        self.cur = np.array(keys0, np.uint32)
        self.rows, self.restart_keys = rows, restart_keys
        self.step, self.pending, self.restarted = 0, None, []

    def draw(self, n):
        if self.pending is None:
            idx = np.arange(self.cur.shape[0])
        else:
            idx, self.pending = self.pending, None
            self.cur[idx] = self.restart_keys[self.step - 1][idx]
        assert n == idx.size, (n, idx)
        pairs = jax.vmap(jax.random.split)(jnp.asarray(self.cur[idx]))
        picks = jax.vmap(lambda k: jax.random.randint(k, (), 0, self.rows))(pairs[:, 1])
        self.cur[idx] = np.asarray(pairs[:, 0])
        return torch.from_numpy(np.array(picks)).long()

    def install(self, monkeypatch):
        real = tenv.draws

        class Draws(types.ModuleType):
            def __getattr__(self, name):
                return getattr(real, name)

        stub = Draws("draws")
        stub.draw_rows = lambda n, fn: self.draw(n)
        monkeypatch.setattr(tenv, "draws", stub)

    def watch(self, inner):
        """``inner`` (a reset_done) that first notes the envs it restarts."""
        def reset_done(*a, **k):
            done = a[4] if len(a) > 4 else a[2]   # rollout's (..., done, gen) or the env's
            idx = torch.nonzero(done).squeeze(1).numpy()
            self.step += 1
            self.restarted.append(idx)
            if idx.size:
                self.pending = idx
            out = inner(*a, **k)
            assert self.pending is None, "a restart drew no noise"
            return out

        return reset_done


# ---------------------------------------------------------------------------
# state comparisons
# ---------------------------------------------------------------------------


def _adam_state(opt_state):
    """The ScaleByAdamState inside an optax state (adam, or clip + adam)."""
    if hasattr(opt_state, "mu"):
        return opt_state
    for s in opt_state:
        got = _adam_state(s) if isinstance(s, tuple) else None
        if got is not None:
            return got
    return None


def _compare_sac(tstate, jstate, kinds, tag, updates_done):
    nets = (("actor", 0, "actor"), ("critic1", 1, "critic1"), ("critic2", 1, "critic2"),
            ("target1", 1, None), ("target2", 1, None))
    for field, k, opt_name in nets:
        want = interop.sac_from_numpy(
            jax.tree.map(np.asarray, getattr(jstate, f"{field}_params")), kinds[k])
        mod = getattr(tstate, field)
        got = dict(mod.named_parameters())
        for name, v in want.items():
            _rel(got[name], v.numpy(), f"{tag}: {field}.{name}")
        if opt_name is None:
            continue
        adam = _adam_state(getattr(jstate, f"{opt_name}_opt"))
        mu = interop.sac_from_numpy(jax.tree.map(np.asarray, adam.mu), kinds[k])
        nu = interop.sac_from_numpy(jax.tree.map(np.asarray, adam.nu), kinds[k])
        opt = getattr(tstate, f"{opt_name}_opt")
        for name, p in mod.named_parameters():
            st = opt.state.get(p)
            if not updates_done:
                assert st is None or not st, f"{tag}: {field} stepped in the warm-up"
                continue
            _rel(st["exp_avg"], mu[name].numpy(), f"{tag}: Adam mu of {field}.{name}")
            _rel(st["exp_avg_sq"], nu[name].numpy(), f"{tag}: Adam nu of {field}.{name}")
            assert int(st["step"]) == int(adam.count) == updates_done, (tag, field)


def _compare_replay(tbuf, jbuf, tag):
    assert (tbuf.ptr, tbuf.size) == (int(jbuf.ptr), int(jbuf.size)), tag
    for f in ("obs", "action", "reward", "next_obs"):
        _rel(getattr(tbuf, f), getattr(jbuf, f), f"{tag}: replay {f}")
    np.testing.assert_array_equal(tbuf.done.numpy(), np.asarray(jbuf.done),
                                  err_msg=f"{tag}: replay done")


def _compare_env(ts, js, tag):
    for f in ("x", "steer_buf", "start_pose", "lap_times", "current_time"):
        _rel(getattr(ts, f), getattr(js, f), f"{tag}: {f}")
    for f in ("collisions", "near_starts", "toggle_list", "lap_counts", "steer_cnt"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                      err_msg=f"{tag}: {f}")


def _compare_metrics(tm, jm, tag):
    for k in ("reward", "done", "actor_loss"):
        _rel(tm[k], jm[k], f"{tag}: metric {k}", rtol=METRIC_RTOL, atol=1e-12)


def _f64(tree):
    return jax.tree.map(lambda x: x.astype(jnp.float64), tree)


def _port_sac_from_jax(ts, jstate, kinds):
    tstate = ts.init(torch.Generator().manual_seed(0))
    for mod, tree, k in ((tstate.actor, jstate.actor_params, kinds[0]),
                         (tstate.critic1, jstate.critic1_params, kinds[1]),
                         (tstate.critic2, jstate.critic2_params, kinds[1]),
                         (tstate.target1, jstate.target1_params, kinds[1]),
                         (tstate.target2, jstate.target2_params, kinds[1])):
        mod.load_state_dict(interop.sac_from_numpy(jax.tree.map(np.asarray, tree), k))
    return tstate


def _jax_state_f64(js, st):
    """JAX's initial SAC state cast to float64, Adams fresh."""
    ap, c1, c2 = _f64(st.actor_params), _f64(st.critic1_params), _f64(st.critic2_params)
    return jsac.SACState(ap, c1, c2, c1, c2, js.actor_tx.init(ap), js.critic_tx.init(c1),
                         js.critic_tx.init(c2))


def _float64_replay(tbuf, obs_dtype):
    """The port's replay with float64 actions, rewards and dones, as JAX's
    is under float64 (``_f64_sac`` makes its float32 fields float64)."""
    cap = tbuf.capacity
    z = lambda *s, dt=torch.float64: torch.zeros(s, dtype=dt)  # noqa: E731
    return tsac.ReplayBuffer(obs=z(cap, *tbuf.obs.shape[1:], dt=obs_dtype),
                             action=z(cap, tbuf.action.shape[1]), reward=z(cap),
                             next_obs=z(cap, *tbuf.obs.shape[1:], dt=obs_dtype), done=z(cap))


def _pool_from_jax(tparams, jparams):
    pool = torch.from_numpy(np.array(jparams.noise_pool, np.float64)).to(
        tparams.noise_pool.dtype)
    return tparams._replace(noise_pool=pool)


# ---------------------------------------------------------------------------
# the scan trainer
# ---------------------------------------------------------------------------


def _scale_args(envs, steps, **kw):
    args = tsc.parse_args(["--device", "cpu", "--envs", str(envs), "--beams", str(BEAMS),
                           "--steps-per-iter", str(steps), "--batch-size", "8",
                           "--capacity", str(kw.get("capacity", 200)),
                           "--updates-per-step", str(kw.get("updates", 2)),
                           "--warmup-iters", str(kw.get("warmup", 1))])
    return args, argparse.Namespace(**{k: getattr(args, k) for k in (
        "envs", "steps_per_iter", "batch_size", "updates_per_step", "capacity", "beams",
        "warmup_iters")})


def _scale_pair(monkeypatch, args, jargs, cfg_kw, jcfg_kw, poses, iters, f64):
    """Both scan trainers on track_0019 from ``poses``, their draws
    injected -> (port trainer, JAX trainer, env chains)."""
    chain = _scale_chain(jax.random.PRNGKey(2), iters, args.steps_per_iter,
                         args.updates_per_step, args.warmup_iters, args.envs)
    slabs = _Slabs(chain, args.envs, args.batch_size, args.capacity,
                   np.random.default_rng(3), 2, uniform_warmup=False)
    jdraws = slabs.jax_draws()
    monkeypatch.setattr(jsac, "jax", jdraws)
    if f64:
        monkeypatch.setattr(jsac, "jnp", _Float64Numpy("jnp64"))
    jcfg = JSimConfig(**jcfg_kw, integrator=JIntegrator.RK4)
    jt = learning_ab.build_sac_scale(jargs, assets.named_map_yaml(TRACK), poses,
                                     random=jdraws.random, cfg=jcfg,
                                     compute_dtype=jnp.float64 if f64 else None)

    chains = _EnvChains(jax.random.split(jax.random.PRNGKey(0), args.envs),
                        jcfg.noise_pool_rows, [st["rkeys"] for st in chain])
    chains.install(monkeypatch)
    slabs.port_draws(monkeypatch)
    monkeypatch.setattr(trollout, "reset_done", chains.watch(trollout.reset_done))
    t = tsc.build(args, TSimConfig(**cfg_kw, integrator=TIntegrator.RK4))
    t.params = _pool_from_jax(t.params, jt.params)
    # reset again at ``poses``, with the pool come across, from the chains' start
    chains.cur = np.array(jax.random.split(jax.random.PRNGKey(0), args.envs), np.uint32)
    t.states, t.obs, *_ = tenv.reset(t.cfg, t.params, torch.as_tensor(
        poses, dtype=t.cfg.tdtype), t.gen)
    kinds = ("scan_actor", "scan_critic")
    if f64:
        jt.sstate = _jax_state_f64(jt.sac, jt.sstate)
        t.sac = tsac.SAC(obs_shape=(BEAMS,), action_dim=2,
                         actor=tsac.ScanActor(BEAMS, 2, compute_dtype=torch.float64),
                         critic=tsac.ScanCritic(BEAMS, 2, compute_dtype=torch.float64),
                         obs_dtype=torch.float32, device="cpu")
        t.buf = _float64_replay(t.buf, torch.float32)
    t.sstate = _port_sac_from_jax(t.sac, jt.sstate, kinds)
    return t, jt, chains, kinds


def test_three_scan_trainer_iterations_float64_match_jax(monkeypatch):
    """Three iterations of 8 steps of 4 envs: iteration 0 warms up,
    iterations 1 and 2 make 2 updates a step; envs 1 and 3 face a wall 0.25
    and 0.1 m past their crash distance, so they restart in every
    iteration; the 50-transition replay wraps in iteration 1."""
    args, jargs = _scale_args(4, 8, capacity=50)
    kw = dict(num_agents=1, num_beams=BEAMS, timestep=0.01, dtype="float64",
              scan_mode="exact")
    poses = _wall_poses(4, {1: 2.3, 3: 2.4})
    t, jt, chains, kinds = _scale_pair(monkeypatch, args, jargs, kw, kw, poses, ITERS, True)
    _compare_env(t.states, jt.states, "reset")
    _rel(t.obs.scans, jt.obs.scans, "reset: scans")
    restarts = 0
    for it in range(ITERS):
        jm = learning_ab.scale_iteration(jt, it)
        acc, _ = tsc.iteration(t, it >= args.warmup_iters)
        tm = tsc.Metrics.means(acc)
        tag = f"iteration {it}"
        _compare_replay(t.buf, jt.buf, tag)
        _compare_env(t.states, jt.states, tag)
        _compare_metrics(tm, jm, tag)
        _rel(t.obs.scans, jt.obs.scans, f"{tag}: scans")
        _compare_sac(t.sstate, jt.sstate, kinds, tag,
                     max(0, it + 1 - args.warmup_iters) * args.steps_per_iter
                     * args.updates_per_step)
        restarts += sum(i.size for i in chains.restarted[-args.steps_per_iter:])
        assert any(i.size for i in chains.restarted[-args.steps_per_iter:]), \
            f"{tag}: no env restarted"
    assert jt.buf.size == args.capacity and int(jt.buf.ptr) == (ITERS * 8 * 4) % 50
    assert restarts > 0


def test_scan_trainer_iteration_float32_matches_jax(monkeypatch, tmp_path):
    """One iteration of 8 steps of 8 envs at the trainer's scan config, with
    an update after each step; envs 1, 3, 5 and 7 face the wall, and two of
    them hit it and restart inside the iteration."""
    monkeypatch.setenv("RED_GYM_TPU_TEXTURE_CACHE", str(tmp_path))
    args, jargs = _scale_args(8, 8, capacity=200, updates=1, warmup=0)
    kw = dict(num_agents=1, num_beams=BEAMS, timestep=0.01, dtype="float32",
              scan_mode="fast", scan_interp="spectral", rt_pose_stride=16)
    jkw = dict(kw, scan_backend="pallas", fuse_scan_ttc="on")
    poses = _wall_poses(8, {1: 2.4, 3: 2.45, 5: 2.5, 7: 2.55}).astype(np.float32)
    t, jt, chains, _ = _scale_pair(monkeypatch, args, jargs, kw, jkw, poses, 1, False)
    learning_ab.scale_iteration(jt, 0)
    tsc.iteration(t, True)

    n = t.buf.size
    assert n == int(jt.buf.size) == 64
    jd = np.asarray(jt.buf.done)[:n]
    np.testing.assert_array_equal(t.buf.done[:n].numpy(), jd)
    assert jd.sum() > 0, "no env restarted"
    assert set(np.nonzero(jd)[0] % 8) <= {1, 3, 5, 7}
    cell = float(t.params.rtex.cell)
    for f in ("obs", "next_obs"):
        err = np.abs(getattr(t.buf, f)[:n].numpy().astype(np.float64)
                     - np.asarray(getattr(jt.buf, f))[:n])
        assert np.quantile(err, 0.99) < 1e-3, (f, np.quantile(err, 0.99))
        assert np.mean(err > 4 * cell) < 2e-3, (f, np.mean(err > 4 * cell))
    _rel(t.buf.action[:n], np.asarray(jt.buf.action)[:n], "actions", rtol=0, atol=1e-4)
    _rel(t.buf.reward[:n], np.asarray(jt.buf.reward)[:n], "rewards", rtol=0, atol=1e-4)
    np.testing.assert_allclose(t.states.x[..., [0, 1, 4]].numpy(),
                               np.asarray(jt.states.x)[..., [0, 1, 4]], rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# the bitmap trainer
# ---------------------------------------------------------------------------


def test_three_bitmap_trainer_iterations_float64_match_jax(monkeypatch):
    """Three iterations of 8 planning steps of 4 envs at 64 px: iteration 0
    takes uniform actions, iterations 1 and 2 the policy's and 2 updates a
    step (grad clip 10, which binds); envs 1 and 3 face a wall and env 2
    has its back to it.  The 48-transition replay wraps in iteration 1."""
    args = tbm.parse_args(["--device", "cpu", "--envs", "4", "--steps-per-iter", "8",
                           "--bitmap", "64", "--beams", str(BEAMS), "--batch-size", "8",
                           "--capacity", "48", "--updates-per-step", "2", "--warmup-iters",
                           "1", "--alpha", "0.02", "--f32", "--seed", "3"])
    jargs = argparse.Namespace(**vars(args))
    kw = dict(num_agents=1, num_beams=BEAMS, timestep=0.015, dtype="float64")
    poses = _wall_poses(4, {1: 2.5, 2: -2.5, 3: 2.5})
    keys0, chain = _bitmap_chain(jax.random.PRNGKey(args.seed), ITERS, args.steps_per_iter,
                                 args.updates_per_step, args.warmup_iters, args.envs)
    slabs = _Slabs(chain, args.envs, args.batch_size, args.capacity,
                   np.random.default_rng(4), tpe.ACTION_DIM, uniform_warmup=True)
    slabs.uniform_dtype = jnp.float64
    jdraws = slabs.jax_draws()
    monkeypatch.setattr(jsac, "jax", jdraws)
    monkeypatch.setattr(jsac, "jnp", _Float64Numpy("jnp64"))
    jt = learning_ab.build_sac_bitmap(jargs, assets.named_map_yaml(TRACK), poses,
                                      random=jdraws.random, cfg=JSimConfig(**kw),
                                      compute_dtype=jnp.float64)
    chains = _EnvChains(keys0, jt.cfg.noise_pool_rows, [st["rkeys"] for st in chain])
    chains.install(monkeypatch)
    slabs.port_draws(monkeypatch)
    monkeypatch.setattr(tpe.PlanningEnv, "reset_done", chains.watch(tpe.PlanningEnv.reset_done))
    t = tbm.build(args, TSimConfig(**kw))
    t.env.env_params = _pool_from_jax(t.env.env_params, jt.params)
    # reset again at ``poses``, with the pool come across, from the chains' start
    chains.cur = np.array(keys0, np.uint32)
    t.ps = t.env.reset(torch.as_tensor(poses), t.gen)

    kinds = ("actor", "critic")
    jt.sstate = _jax_state_f64(jt.sac, jt.sstate)
    t.sac = tsac.SAC(obs_shape=(64, 64), action_dim=tpe.ACTION_DIM, alpha=args.alpha,
                     grad_clip=args.grad_clip, compute_dtype=torch.float64, device="cpu")
    t.sstate = _port_sac_from_jax(t.sac, jt.sstate, kinds)
    t.buf = _float64_replay(t.buf, torch.uint8)

    def compare_plan(tag):
        _compare_env(t.ps.env_state, jt.ps.env_state, tag)
        _rel(t.ps.obs.scans, jt.ps.obs.scans, f"{tag}: scans")
        np.testing.assert_array_equal(t.ps.bitmap.numpy(), np.asarray(jt.ps.bitmap),
                                      err_msg=f"{tag}: bitmaps")
        _rel(t.ps.path, jt.ps.path, f"{tag}: path")
        _rel(t.ps.prev_pos, jt.ps.prev_pos, f"{tag}: prev_pos")
        np.testing.assert_array_equal(t.ps.sub_index.numpy(), np.asarray(jt.ps.sub_index),
                                      err_msg=f"{tag}: sub_index")

    compare_plan("reset")
    for it in range(ITERS):
        jm = learning_ab.bitmap_iteration(jt, it)
        acc, _ = tbm.iteration(t, it >= args.warmup_iters)
        tm = tbm.Metrics.means(acc)
        tag = f"iteration {it}"
        _compare_replay(t.buf, jt.buf, tag)
        compare_plan(tag)
        _compare_metrics(tm, jm, tag)
        _compare_sac(t.sstate, jt.sstate, kinds, tag,
                     max(0, it + 1 - args.warmup_iters) * args.steps_per_iter
                     * args.updates_per_step)
        assert any(i.size for i in chains.restarted[-args.steps_per_iter:]), \
            f"{tag}: no env restarted"
    assert jt.buf.size == args.capacity
    assert slabs.count == dict(normal=len(slabs.n_keys), randint=len(slabs.i_keys),
                               uniform=len(slabs.u_keys))


# ---------------------------------------------------------------------------
# the lap logic on driven crossings
# ---------------------------------------------------------------------------


def _raceline_drive(track, offsets, laps, speed=8.0, dt=0.01):
    """(steps, E, 2) positions: the raceline from its start waypoint at
    ``speed``, ``laps`` times round, env e shifted ``offsets[e]`` m to the
    left of the direction of travel; and the start pose (1, 3)."""
    w = np.loadtxt(assets.waypoints_csv(track), delimiter=";", comments="#")[:, 1:3]
    start = assets.waypoint_start_poses(track, 1)
    closed = np.vstack([w, w[:1]])
    seg = np.linalg.norm(np.diff(closed, axis=0), axis=1)
    s_knots = np.concatenate([[0.0], np.cumsum(seg)])
    length = s_knots[-1]
    s = (np.arange(int(laps * length / (speed * dt))) * speed * dt) % length
    x = np.interp(s, s_knots, closed[:, 0])
    y = np.interp(s, s_knots, closed[:, 1])
    k = np.clip(np.searchsorted(s_knots, s, side="right") - 1, 0, len(seg) - 1)
    tangent = (closed[k + 1] - closed[k]) / seg[k][:, None]
    normal = np.stack([-tangent[:, 1], tangent[:, 0]], axis=1)
    pos = np.stack([x, y], 1)[:, None, :] + np.asarray(offsets)[None, :, None] * normal[:, None]
    return pos, start


@pytest.mark.parametrize("track", ["track_0101", "track_0019"])
def test_lap_logic_on_driven_crossings_matches_jax(track):
    # the line counts a crossing up to 2.0 + sqrt(0.1) = 2.316 m to the side
    offsets = [0.0, 0.5, -1.0, 1.9, -1.99, 2.05, -2.1, 2.3, -2.34, 2.6, -3.2]
    pos, start = _raceline_drive(track, offsets, laps=3)
    e_n = len(offsets)
    jcfg, tcfg = JSimConfig(num_agents=1, dtype="float64"), TSimConfig(num_agents=1,
                                                                        dtype="float64")
    poses = np.repeat(start[None], e_n, axis=0)
    ts = tenv.init_state(tcfg, torch.from_numpy(poses))
    js = jax.vmap(lambda p: jenv.init_state(jcfg, p, jax.random.PRNGKey(0)))(
        jnp.asarray(poses))

    def jax_step(js, xy_t):
        xy, t = xy_t
        js = js._replace(x=js.x.at[:, 0, 0:2].set(xy),
                         current_time=jnp.full(js.current_time.shape, t))
        js, done, _ = jax.vmap(lambda s: jenv._lap_done_update(jcfg, s))(js)
        return js, (js.lap_counts[:, 0], js.toggle_list[:, 0], js.near_starts[:, 0],
                    js.lap_times[:, 0], done)

    times = 0.01 * np.arange(1, pos.shape[0] + 1)
    _, jout = jax.jit(lambda s: jax.lax.scan(jax_step, s, (jnp.asarray(pos),
                                                          jnp.asarray(times))))(js)
    jout = [np.asarray(a) for a in jout]
    reach = tcfg.finish_band_halfwidth + np.sqrt(tcfg.finish_dist2)
    lats = []
    for i in range(pos.shape[0]):
        x = ts.x.clone()
        x[:, 0, 0:2] = torch.from_numpy(pos[i])
        ts = ts._replace(x=x, current_time=torch.full((e_n,), times[i], dtype=torch.float64))
        ts, done, _ = tenv._lap_done_update(tcfg, ts)
        got = (ts.lap_counts[:, 0], ts.toggle_list[:, 0], ts.near_starts[:, 0],
               ts.lap_times[:, 0], done)
        for name, g, j in zip(("lap_counts", "toggles", "near_starts", "lap_times", "done"),
                              got, jout):
            np.testing.assert_array_equal(g.numpy(), j[i], err_msg=f"step {i}: {name}")
        lats.append(generalization_study.start_frame(ts)[1].numpy())
    laps = jout[0][-1]
    inside = np.abs(np.asarray(offsets)) <= reach
    assert inside.sum() == 8
    # three laps driven: laps count within the line's reach (done at the
    # second), none beyond it
    assert (laps[inside] >= 2).all() and (laps[~inside] == 0).all(), laps
    assert jout[4][-1][inside].all() and not jout[4][-1][~inside].any()
    # the study's lateral offset is the lap logic's, here the offset driven
    np.testing.assert_allclose(np.asarray(lats)[0], np.asarray(offsets), atol=1e-9)
