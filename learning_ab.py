#!/usr/bin/env python3
"""JAX's two SAC trainers on any packaged map and start, on the CPU: the
reference runs that tell what a map does to a learning curve from what the
port does to it.

``examples/train_sac_scale.py`` and ``examples/train_sac_bitmap_scale.py``
keep their trainers inside ``main()`` closures, read the reference example
map and hard-code its start (0.7, 0.0, 1.3708), which lies in a wall on
``track_0019``.  This file copies their bodies statement for statement:

- ``build_sac_scale`` and ``run_sac_scale``: ``examples/train_sac_scale.py:56-162``;
- ``build_sac_bitmap`` and ``run_sac_bitmap``:
  ``examples/train_sac_bitmap_scale.py:84-181``.

What is an argument here and a constant there: the map yaml, the start poses
(E, 1, 3), the seed offset S and the draw source (``random``, the module
whose ``split``, ``fold_in`` and ``uniform`` the trainer bodies call;
``jax.random`` by default, a stand-in in tests).  The scan trainer has no
``--seed``: S shifts each of its three keys, ``PRNGKey(0 + S)`` (the resets),
``PRNGKey(1 + S)`` (SAC's init) and ``PRNGKey(2 + S)`` (the loop), as the
port's ``train_sac_scale --seed S`` shifts its generators.  ``cfg`` and
``compute_dtype`` may be given (tests run float64); by default they are the
trainers' own, and the bitmap trainer's plan constants take the config's
dtype (float32 at the trainer's config, JAX's default).  Left out: the TPU
platform shim, ``--resume`` and the checkpoints (``--save``), which do not
touch learning.  JAX's order of draws, its keys, ``fold_in``s and
``Metrics`` are unchanged.  Nothing of the JAX package is edited, and no
module of ``red_gym_tpu_torch`` imports this file.

The CLI runs on the CPU with JAX's own defaults (float64 off), on a packaged
track with the port's starts: ``assets.waypoint_start_poses`` for the scan
trainer; for the bitmap trainer the stagger of the port's
``train_sac_bitmap_scale.start_poses`` (env e 0.05 m x (e % 8) back along
the start's heading), computed in numpy the same way.  It writes JAX's CSV
columns.

    python3 learning_ab.py sac_scale --envs 128 --iters 1200 --updates-per-step 4 \\
        --batch-size 512 --seed 0 --log-csv docs/media/sac_jax_cpu_track0019_scale_seed0.csv
    python3 learning_ab.py sac_bitmap --envs 32 --iters 400 --steps-per-iter 16 \\
        --bitmap 128 --f32 --alpha 0.02 --seed 0 \\
        --log-csv docs/media/sac_jax_cpu_track0019_bitmap_seed0.csv

The third arm, ``ppo``, copies no trainer body: it runs JAX's own
``examples/train_ppo.py --multi-map`` unmodified, in a child process
(``ppo_child``: this file again, ``ppo-child``, which imports JAX, forces the
CPU through ``jax.config`` and hands the trainer its ``sys.argv`` through
``runpy``).  ``--multi-map`` builds the 11 packaged tracks and the starts at
waypoint rows 0 and 8 itself (``examples/train_ppo.py:89-107``), so no map is
read from outside the repository.  ``--law`` is JAX's key law, set in the
child's environment before JAX is imported: ``jax09`` is
``JAX_THREEFRY_PARTITIONABLE=1`` (JAX 0.5 and later, where ``split(k, n)[j]``
does not depend on n; the law the port follows), ``fresh`` is ``=0`` (the
law before 0.5, where it does).  The child prints ``jax.__version__`` and
the flag as JAX read it on the first line of its output.  Every other flag
stays at ``train_ppo``'s own default: rollout 32, 2 agents, 1080 beams,
float32, the bilinear edge + grad scan, ``--opponents cruise``.  On the CPU
JAX's fast scan takes its non-Pallas path for the bilinear edge + grad
epilogue (the Pallas kernel 4 is a TPU kernel); that is JAX's behaviour,
and the port's kernel 4 is held to it at the float32 bar in
``tests/test_torch_ppo.py``.

The committed A/B runs at 1024 envs x 100 iterations, cut from the
16384 envs of the TPU's curves (``docs/media/ppo_multimap_seed*.csv``) so
that JAX runs on the CPU; the pilot that chose the size is in PERF.md:

    python3 learning_ab.py ppo --law jax09 --envs 1024 --iters 100 --seed 0 \\
        --log-csv docs/media/ppo_jax_cpu_multimap_jax09_n1024_seed0.csv
    python3 learning_ab.py ppo --law fresh --envs 1024 --iters 100 --seed 0 \\
        --log-csv docs/media/ppo_jax_cpu_multimap_fresh_n1024_seed0.csv
"""

from __future__ import annotations

import argparse
import functools
import os
import runpy
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

STAGGER_M, STAGGER_ROWS = 0.05, 8
ROOT = os.path.dirname(os.path.abspath(__file__))
TRAIN_PPO = os.path.join(ROOT, "examples", "train_ppo.py")
# --law -> JAX_THREEFRY_PARTITIONABLE in the child's environment
LAWS = {"jax09": "1", "fresh": "0"}


def scale_parser() -> argparse.ArgumentParser:
    """``examples/train_sac_scale.py``'s flags, with its defaults."""
    ap = argparse.ArgumentParser(prog="learning_ab.py sac_scale")
    ap.add_argument("--envs", type=int, default=512)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--steps-per-iter", type=int, default=32)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--log-csv", type=str, default=None)
    ap.add_argument("--updates-per-step", type=int, default=1)
    ap.add_argument("--capacity", type=int, default=200_000)
    ap.add_argument("--beams", type=int, default=1080)
    ap.add_argument("--warmup-iters", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0,
                    help="offset S of the trainer's three keys (JAX's trainer: S = 0)")
    ap.add_argument("--track", type=str, default="track_0019")
    return ap


def bitmap_parser() -> argparse.ArgumentParser:
    """``examples/train_sac_bitmap_scale.py``'s learning flags, with its defaults."""
    ap = argparse.ArgumentParser(prog="learning_ab.py sac_bitmap")
    ap.add_argument("--envs", type=int, default=64)
    ap.add_argument("--iters", type=int, default=120)
    ap.add_argument("--steps-per-iter", type=int, default=32)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--updates-per-step", type=int, default=1)
    ap.add_argument("--capacity", type=int, default=25_000)
    ap.add_argument("--bitmap", type=int, default=256)
    ap.add_argument("--beams", type=int, default=1080)
    ap.add_argument("--warmup-iters", type=int, default=2)
    ap.add_argument("--log-csv", type=str, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reward-mode", choices=("sal", "fixed"), default="fixed")
    ap.add_argument("--grad-clip", type=float, default=10.0)
    ap.add_argument("--alpha", type=float, default=0.2)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--track", type=str, default="track_0019")
    return ap


def bitmap_start_poses(start, envs: int) -> np.ndarray:
    """(E, 1, 3) float32: ``start`` (1, 3), env e STAGGER_M x (e % 8) back
    along the start's heading, in float64 and cast last, as the port's
    ``train_sac_bitmap_scale.start_poses``."""
    start = np.asarray(start, np.float64)
    back = STAGGER_M * (np.arange(envs, dtype=np.float64) % STAGGER_ROWS)
    poses = np.repeat(start[None], envs, axis=0)
    poses[:, 0, 0] -= back * np.cos(start[0, 2])
    poses[:, 0, 1] -= back * np.sin(start[0, 2])
    return poses.astype(np.float32)


# ---------------------------------------------------------------------------
# examples/train_sac_scale.py:56-162
# ---------------------------------------------------------------------------


def build_sac_scale(args, map_yaml: str, start, seed: int = 0, random=None, cfg=None,
                    compute_dtype=None):
    """The scan trainer of ``args`` on ``map_yaml``, every car at ``start``
    (1, 3) (or env e at ``start[e]``, (E, 1, 3)) -> a namespace with its
    config, params, SAC, the carry (``sstate``, ``buf``, ``states``,
    ``obs``, ``key``) and its two jitted iterations (``warmup_it``,
    ``train_it``)."""
    import jax
    import jax.numpy as jnp

    from red_gym_tpu import env as envlib
    from red_gym_tpu.agents import sac as sac_lib
    from red_gym_tpu.config import Integrator, SimConfig
    from red_gym_tpu.utils.profiling import Metrics

    random = random or jax.random
    compute_dtype = compute_dtype or jnp.float32
    cfg = cfg or SimConfig(num_agents=1, num_beams=args.beams, timestep=0.01,
                           integrator=Integrator.RK4, dtype="float32",
                           scan_mode="fast", scan_interp="spectral")
    params = envlib.make_params(cfg, map_yaml, ".png")

    sac = sac_lib.SAC(obs_shape=(args.beams,), action_dim=2,
                      actor=sac_lib.ScanActor(action_dim=2, compute_dtype=compute_dtype),
                      critic=sac_lib.ScanCritic(compute_dtype=compute_dtype),
                      obs_dtype=jnp.float32)
    sstate = sac.init(random.PRNGKey(1 + seed))
    buf = sac_lib.ReplayBuffer.create(args.capacity, (args.beams,), 2,
                                      obs_dtype=jnp.float32)

    start = jnp.asarray(start, cfg.jdtype)
    poses = (jnp.tile(start.reshape(1, 3), (args.envs, 1, 1)) if start.size == 3
             else start.reshape(args.envs, 1, 3))
    keys = random.split(random.PRNGKey(0 + seed), args.envs)
    reset_v = jax.jit(jax.vmap(
        lambda pr, po, k: envlib.reset(cfg, pr, po, k), in_axes=(None, 0, 0)))
    states, obs, *_ = reset_v(params, poses, keys)

    step_v = jax.vmap(lambda pr, s, a: envlib.step(cfg, pr, s, a),
                      in_axes=(None, 0, 0))
    reset_vj = jax.vmap(lambda pr, po, k: envlib.reset(cfg, pr, po, k),
                        in_axes=(None, 0, 0))

    def to_control(act):
        steer = 0.4 * act[..., 0]
        speed = 4.0 * (act[..., 1] + 1.0)   # tanh output in [-1,1] -> [0,8]
        return jnp.stack([steer, speed], axis=-1)[:, None, :]

    def make_iteration(do_update: bool):
        def body(pr, carry, _):
            sstate, buf, states, obs, key, acc = carry
            key, ka, kb, kr, ku = random.split(key, 5)

            scan_obs = obs.scans[:, 0]
            act, _ = sac_lib.sample_action(sstate.actor_params, sac.actor,
                                           scan_obs, ka)
            states2, obs2, _, done, _ = step_v(pr, states, to_control(act))
            r = (10.0 * obs2.linear_vels_x[:, 0] * cfg.timestep
                 - 100.0 * obs2.collisions[:, 0])
            buf = buf.push_batch(scan_obs, act, r, obs2.scans[:, 0], done)

            rkeys = random.split(kr, done.shape[0])
            r_states, r_obs, *_ = reset_vj(pr, states2.start_pose, rkeys)
            sel = lambda a_, b_: jnp.where(  # noqa: E731
                done.reshape((-1,) + (1,) * (a_.ndim - 1)), a_, b_)
            states2 = jax.tree.map(sel, r_states, states2)
            obs2 = jax.tree.map(sel, r_obs, obs2)

            actor_loss = jnp.float32(0)
            if do_update:
                for j in range(args.updates_per_step):
                    kb_j = random.fold_in(kb, j)
                    ku_j = random.fold_in(ku, j)
                    batch = buf.sample(kb_j, args.batch_size)
                    sstate, losses = sac.update(sstate, batch, ku_j)
                actor_loss = losses["actor_loss"]
            acc = Metrics.update(acc, reward=r.mean(), done=done.mean(),
                                 actor_loss=actor_loss)
            return (sstate, buf, states2, obs2, key, acc), None

        @jax.jit
        def iteration(pr, sstate, buf, states, obs, key):
            acc = Metrics.init(("reward", "done", "actor_loss"))
            (sstate, buf, states, obs, key, acc), _ = jax.lax.scan(
                lambda c, x: body(pr, c, x),
                (sstate, buf, states, obs, key, acc),
                None, length=args.steps_per_iter)
            return sstate, buf, states, obs, key, acc

        return iteration

    return types.SimpleNamespace(
        args=args, cfg=cfg, params=params, sac=sac, sstate=sstate, buf=buf,
        states=states, obs=obs, key=random.PRNGKey(2 + seed),
        warmup_it=make_iteration(do_update=False), train_it=make_iteration(do_update=True),
        metrics=Metrics)


def scale_iteration(t, it: int) -> dict:
    """Iteration ``it`` of the scan trainer ``t`` (warm-up below
    ``--warmup-iters``), its carry updated -> the metric means."""
    fn = t.warmup_it if it < t.args.warmup_iters else t.train_it
    t.sstate, t.buf, t.states, t.obs, t.key, acc = fn(t.params, t.sstate, t.buf, t.states,
                                                      t.obs, t.key)
    return t.metrics.means(acc)


def run_sac_scale(args, map_yaml: str, start) -> None:
    t = build_sac_scale(args, map_yaml, start, seed=args.seed)
    spi = args.envs * args.steps_per_iter
    csv_f = None
    if args.log_csv:
        csv_f = open(args.log_csv, "w")
        csv_f.write("iter,env_steps,reward,done_rate,actor_loss,wall_s\n")
    t_start = time.time()
    for it in range(args.iters):
        t0 = time.time()
        m = scale_iteration(t, it)
        r = m["reward"]
        dt = time.time() - t0
        print(f"iter {it}: reward={r:.4f} done_rate={m['done']:.3f} "
              f"actor_loss={m['actor_loss']:.4f} "
              f"buf={int(t.buf.size)} ({spi / dt:,.0f} env-steps/s)", flush=True)
        if csv_f:
            csv_f.write(f"{it},{(it + 1) * spi},{r:.6f},{m['done']:.6f},"
                        f"{m['actor_loss']:.6f},{time.time() - t_start:.2f}\n")
            csv_f.flush()
    if csv_f:
        csv_f.close()


# ---------------------------------------------------------------------------
# examples/train_sac_bitmap_scale.py:84-181
# ---------------------------------------------------------------------------


def build_sac_bitmap(args, map_yaml: str, poses, random=None, cfg=None, compute_dtype=None):
    """The bitmap trainer of ``args`` on ``map_yaml``, env e reset at
    ``poses[e]`` (E, 1, 3), seeded by ``args.seed`` -> a namespace with its
    config, planning env, SAC, the carry (``sstate``, ``buf``, ``ps``,
    ``key``) and its jitted ``iteration(sstate, buf, ps, key, do_update)``."""
    import jax
    import jax.numpy as jnp

    from red_gym_tpu import env as envlib
    from red_gym_tpu.agents import planning_env as pe
    from red_gym_tpu.agents.sac import SAC, ReplayBuffer
    from red_gym_tpu.config import SimConfig
    from red_gym_tpu.utils.profiling import Metrics

    random = random or jax.random
    cfg = cfg or SimConfig(num_agents=1, num_beams=args.beams, timestep=0.015,
                           dtype="float32")
    params = envlib.make_params(cfg, map_yaml, ".png")
    pcfg = pe.default_plan_config(cfg.jdtype)._replace(
        bitmap_dims=(args.bitmap, args.bitmap))
    env = pe.PlanningEnv(cfg, params, pcfg, reward_mode=args.reward_mode)
    if compute_dtype is None:
        compute_dtype = jnp.float32 if args.f32 else jnp.bfloat16
    sac = SAC(obs_shape=(args.bitmap, args.bitmap), action_dim=pe.ACTION_DIM,
              alpha=args.alpha, grad_clip=args.grad_clip or None,
              compute_dtype=compute_dtype)

    e = args.envs
    poses = jnp.asarray(poses, cfg.jdtype)

    reset_v = jax.jit(jax.vmap(env.reset, in_axes=(0, 0)))
    step_v = jax.vmap(env.step, in_axes=(0, 0))

    key = random.PRNGKey(args.seed)
    key, kr = random.split(key)
    ps = reset_v(poses, random.split(kr, e))

    sstate = sac.init(random.PRNGKey(args.seed + 1))
    buf = ReplayBuffer.create(args.capacity,
                              (args.bitmap, args.bitmap), pe.ACTION_DIM)

    def body(carry, _, do_update):
        sstate, buf, ps, key, acc = carry
        key, ka, kb, ku, kr2 = random.split(key, 5)

        bitmaps = ps.bitmap                                   # (E, H, W)
        if do_update:
            act = sac.select_action(sstate, bitmaps, ka)
        else:
            act = random.uniform(ka, (e, pe.ACTION_DIM),
                                 jnp.float32, -1.0, 1.0)
        ps2, bitmaps2, r, done, _ = step_v(ps, act)
        buf = buf.push_batch(bitmaps, act, r, bitmaps2, done)

        # auto-reset crashed/finished envs
        rkeys = random.split(kr2, e)
        ps_reset = jax.vmap(env.reset, in_axes=(0, 0))(poses, rkeys)
        sel = lambda a_, b_: jnp.where(  # noqa: E731
            done.reshape((-1,) + (1,) * (a_.ndim - 1)), a_, b_)
        ps2 = jax.tree.map(sel, ps_reset, ps2)

        actor_loss = jnp.float32(0)
        if do_update:
            for j in range(args.updates_per_step):
                batch = buf.sample(random.fold_in(kb, j), args.batch_size)
                sstate, losses = sac.update(sstate, batch,
                                            random.fold_in(ku, j))
            actor_loss = losses["actor_loss"]
        acc = Metrics.update(acc, reward=r.mean(), done=done.mean(),
                             actor_loss=actor_loss)
        return (sstate, buf, ps2, key, acc), None

    @functools.partial(jax.jit, static_argnames="do_update")
    def iteration(sstate, buf, ps, key, do_update):
        acc = Metrics.init(("reward", "done", "actor_loss"))
        (sstate, buf, ps, key, acc), _ = jax.lax.scan(
            functools.partial(body, do_update=do_update),
            (sstate, buf, ps, key, acc), None, length=args.steps_per_iter)
        return sstate, buf, ps, key, acc

    return types.SimpleNamespace(args=args, cfg=cfg, params=params, env=env, sac=sac,
                                 sstate=sstate, buf=buf, ps=ps, key=key,
                                 iteration=iteration, metrics=Metrics)


def bitmap_iteration(t, it: int) -> dict:
    """Iteration ``it`` of the bitmap trainer ``t`` (random actions below
    ``--warmup-iters``), its carry updated -> the metric means."""
    t.sstate, t.buf, t.ps, t.key, acc = t.iteration(t.sstate, t.buf, t.ps, t.key,
                                                    it >= t.args.warmup_iters)
    return t.metrics.means(acc)


def run_sac_bitmap(args, map_yaml: str, poses) -> None:
    t = build_sac_bitmap(args, map_yaml, poses)
    if args.log_csv:
        with open(args.log_csv, "w") as f:
            f.write("iter,env_steps,reward_mean,done_rate,actor_loss,secs\n")
    for it in range(args.iters):
        t0 = time.time()
        m = bitmap_iteration(t, it)
        secs = time.time() - t0
        row = (it, (it + 1) * args.steps_per_iter * args.envs,
               float(m["reward"]), float(m["done"]),
               float(m["actor_loss"]), round(secs, 2))
        print("iter %d  env-steps %d  reward %.3f  done %.3f  aloss %.4f  %.1fs"
              % row, flush=True)
        if args.log_csv:
            with open(args.log_csv, "a") as f:
                f.write(",".join(str(v) for v in row) + "\n")


# ---------------------------------------------------------------------------
# examples/train_ppo.py --multi-map, unmodified
# ---------------------------------------------------------------------------


def ppo_parser() -> argparse.ArgumentParser:
    """The flags of the PPO arm; every other flag of ``train_ppo`` keeps its
    default."""
    ap = argparse.ArgumentParser(prog="learning_ab.py ppo")
    ap.add_argument("--law", choices=sorted(LAWS), required=True,
                    help="jax09: JAX_THREEFRY_PARTITIONABLE=1; fresh: =0")
    ap.add_argument("--envs", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-csv", type=str, required=True)
    return ap


def ppo_child(args, save_dir: str) -> tuple[list, dict]:
    """The child's argv and environment for the PPO arm ``args``: this file's
    ``ppo-child`` with ``train_ppo``'s flags, on the CPU under ``--law``."""
    argv = [sys.executable, os.path.abspath(__file__), "ppo-child", "--multi-map",
            "--envs", str(args.envs), "--iters", str(args.iters), "--seed", str(args.seed),
            "--log-csv", os.path.abspath(args.log_csv), "--save", save_dir]
    env = dict(os.environ, JAX_PLATFORMS="cpu", RGT_PLATFORM="cpu",
               JAX_THREEFRY_PARTITIONABLE=LAWS[args.law])
    return argv, env


def run_ppo(args) -> int:
    """JAX's ``train_ppo --multi-map`` in a child under ``args.law`` -> its
    exit code; its checkpoint goes to a temporary directory, removed after."""
    save_dir = tempfile.mkdtemp(prefix="ppo_ab_ckpt_")
    try:
        argv, env = ppo_child(args, save_dir)
        return subprocess.run(argv, env=env, cwd=ROOT).returncode
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)


def ppo_child_main(flags: list) -> int:
    """In the child: JAX on the CPU, its version and key law logged, then
    ``examples/train_ppo.py`` run as ``__main__`` with ``flags``."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    print(f"JAX {jax.__version__}: JAX_THREEFRY_PARTITIONABLE="
          f"{os.environ.get('JAX_THREEFRY_PARTITIONABLE')} "
          f"jax_threefry_partitionable={jax.config.jax_threefry_partitionable}; "
          f"examples/train_ppo.py {' '.join(flags)}", flush=True)
    sys.argv = [TRAIN_PPO] + list(flags)
    runpy.run_path(TRAIN_PPO, run_name="__main__")
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "ppo-child":
        return ppo_child_main(argv[1:])
    if argv and argv[0] == "ppo":
        return run_ppo(ppo_parser().parse_args(argv[1:]))
    if not argv or argv[0] not in ("sac_scale", "sac_bitmap"):
        print(__doc__)
        print("usage: learning_ab.py sac_scale|sac_bitmap|ppo [flags]", file=sys.stderr)
        return 2
    import jax

    jax.config.update("jax_platforms", "cpu")
    from red_gym_tpu_torch import assets

    which, rest = argv[0], argv[1:]
    args = (scale_parser() if which == "sac_scale" else bitmap_parser()).parse_args(rest)
    if args.updates_per_step < 1:
        raise SystemExit("--updates-per-step must be >= 1")
    track = assets.named_map_yaml(args.track)
    start = assets.waypoint_start_poses(track, 1)
    print(f"JAX {jax.__version__} on {jax.default_backend()}: {which} on {args.track}, "
          f"start {start.tolist()}", flush=True)
    if which == "sac_scale":
        run_sac_scale(args, track, start)
    else:
        run_sac_bitmap(args, track, bitmap_start_poses(start, args.envs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
