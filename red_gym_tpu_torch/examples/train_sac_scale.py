"""SAC at scale: batched envs and an on-device replay, on one GPU.

PyTorch counterpart of ``examples/train_sac_scale.py``, with its flags, its
CSV columns and its line per iteration: the scan-MLP SAC (``ScanActor``,
``ScanCritic``) over E envs of one car on the spectral fast scan
(``scan_mode="fast", scan_interp="spectral"``, whose render is TPU kernel 5,
``ops/spectral_kernels.theta_spectral_ttc``), SAL-scale reward shaping
(progress x10, crash -100).  A Python loop over ``--steps-per-iter``
replaces the JAX script's ``lax.scan``; done envs restart from their start
pose through ``rollout.reset_done``.  The CSV has JAX's columns, then the
means of ``SAC.update``'s diagnostics (``agents.sac.UPDATE_DIAGNOSTICS``;
0 in the warm-up iterations).  ``--seed S`` shifts the seed of each
generator by S (the JAX script has no ``--seed``: S = 0 is its run).

Cuts against the JAX script: the map is the packaged ``track_0019`` (the
JAX script's ``example_map.yaml`` is not packaged), cars start on its
``assets.waypoint_start_poses``; ``--save`` names a checkpoint file
(``utils.checkpoint``), not a directory.

Usage:
    python -m red_gym_tpu_torch.examples.train_sac_scale --envs 512 --iters 20

It runs on the card ("cuda") unless ``--device cpu`` is given; there is no
fallback.
"""

import argparse
import time
import types

import torch

from red_gym_tpu_torch import assets, env as envlib, rollout
from red_gym_tpu_torch.agents import sac as sac_lib
from red_gym_tpu_torch.config import Integrator, SimConfig, resolve_device
from red_gym_tpu_torch.utils import checkpoint as ckpt
from red_gym_tpu_torch.utils.profiling import Metrics

TRACK = "track_0019"
HEADER = "iter,env_steps,reward,done_rate,actor_loss,wall_s"   # the JAX script's columns
METRICS = ("reward", "done", "actor_loss") + sac_lib.UPDATE_DIAGNOSTICS


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--envs", type=int, default=512)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--steps-per-iter", type=int, default=32)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--log-csv", type=str, default=None,
                    help="write per-iteration metrics to this CSV")
    ap.add_argument("--updates-per-step", type=int, default=1,
                    help="gradient updates per collected env-step batch (raise to keep "
                         "the replay ratio sane at small env counts)")
    ap.add_argument("--capacity", type=int, default=200_000)
    ap.add_argument("--beams", type=int, default=1080)
    ap.add_argument("--warmup-iters", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0,
                    help="shifts the seed of the env generator (0) and of SAC's init (1)")
    ap.add_argument("--save", type=str, default="sac_scale_ckpt.pt",
                    help="checkpoint file (the JAX script's is an orbax directory)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device; 'cuda' (the default) needs a GPU and does not "
                         "fall back to the CPU")
    args = ap.parse_args(argv)
    if args.updates_per_step < 1:
        ap.error("--updates-per-step must be >= 1")
    return args


def make_config(args) -> SimConfig:
    return SimConfig(num_agents=1, num_beams=args.beams, timestep=0.01,
                     integrator=Integrator.RK4, dtype="float32",
                     scan_mode="fast", scan_interp="spectral")


def build(args, cfg: SimConfig | None = None):
    """The trainer of ``args`` on ``args.device`` (the card by default): env
    params on track_0019 (its range texture marched), E envs reset on its
    start, SAC and its state, the replay and the device generator."""
    device = resolve_device(args.device)
    cfg = cfg or make_config(args)
    track = assets.named_map_yaml(TRACK)
    params = envlib.make_params(cfg, track, ".png", device=device)
    sac = sac_lib.SAC(obs_shape=(args.beams,), action_dim=2,
                      actor=sac_lib.ScanActor(args.beams, action_dim=2),
                      critic=sac_lib.ScanCritic(args.beams, action_dim=2),
                      obs_dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(0 + args.seed)
    start = torch.as_tensor(assets.waypoint_start_poses(track, 1), dtype=cfg.tdtype,
                            device=device)
    states, obs, *_ = envlib.reset(cfg, params, start.expand(args.envs, 1, 3).contiguous(), gen)
    return types.SimpleNamespace(
        args=args, cfg=cfg, device=device, params=params, sac=sac, gen=gen,
        states=states, obs=obs, sstate=sac.init(torch.Generator().manual_seed(1 + args.seed)),
        buf=sac_lib.ReplayBuffer.create(args.capacity, (args.beams,), 2,
                                        obs_dtype=torch.float32, device=device))


def to_control(act):
    steer = 0.4 * act[..., 0]
    speed = 4.0 * (act[..., 1] + 1.0)   # tanh output in [-1,1] -> [0,8]
    return torch.stack([steer, speed], dim=-1)[:, None, :]


def iteration(t, do_update: bool):
    """``steps_per_iter`` env steps of the sampled policy, each pushed to the
    replay, done envs restarted, then ``updates_per_step`` SAC updates ->
    (metric sums, reset steps)."""
    args, cfg = t.args, t.cfg
    acc = Metrics.init(METRICS, device=t.device)
    reset_steps = 0
    for _ in range(args.steps_per_iter):
        scan_obs = t.obs.scans[:, 0]
        act = t.sac.select_action(t.sstate, scan_obs, t.gen)
        states2, obs2, _, done, _ = envlib.step(cfg, t.params, t.states, to_control(act), t.gen)
        # SAL-scale shaping (reference src/SAL.py:219-250 magnitudes:
        # progress x10, crash -100): per-step rewards must dominate the
        # alpha=0.2 entropy term or SAC optimizes entropy alone
        r = (10.0 * obs2.linear_vels_x[:, 0] * cfg.timestep
             - 100.0 * obs2.collisions[:, 0])
        t.buf.push_batch(scan_obs, act, r, obs2.scans[:, 0], done)
        t.states, t.obs, reset_any = rollout.reset_done(cfg, t.params, states2, obs2, done,
                                                        t.gen)
        reset_steps += reset_any
        last = dict.fromkeys(METRICS[2:], 0.0)
        if do_update:
            for _ in range(args.updates_per_step):
                t.sstate, losses = t.sac.update(t.sstate, t.buf.sample(t.gen, args.batch_size),
                                                t.gen)
            last = {k: losses[k] for k in last}
        acc = Metrics.update(acc, reward=r.mean(), done=done.float().mean(), **last)
    return acc, reset_steps


def main(argv=None):
    args = parse_args(argv)
    t = build(args)
    spi = args.envs * args.steps_per_iter
    csv_f = None
    if args.log_csv:
        csv_f = open(args.log_csv, "w")
        csv_f.write(",".join((HEADER,) + METRICS[3:]) + "\n")
    t_start = time.time()
    for it in range(args.iters):
        t0 = time.time()
        acc, _ = iteration(t, it >= args.warmup_iters)
        m = Metrics.means(acc)
        dt = time.time() - t0
        print(f"iter {it}: reward={m['reward']:.4f} done_rate={m['done']:.3f} "
              f"actor_loss={m['actor_loss']:.4f} "
              f"buf={t.buf.size} ({spi / dt:,.0f} env-steps/s)", flush=True)
        if csv_f:
            csv_f.write(f"{it},{(it + 1) * spi},{m['reward']:.6f},{m['done']:.6f},"
                        f"{m['actor_loss']:.6f},{time.time() - t_start:.2f}"
                        + "".join(f",{m[k]:.6f}" for k in METRICS[3:]) + "\n")
            csv_f.flush()
    if csv_f:
        csv_f.close()
    ckpt.save(args.save, t.sstate)
    print(f"saved {args.save}")
    return t


if __name__ == "__main__":
    main()
