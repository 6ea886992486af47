"""Batched bitmap-SAC training: the SAL-parity pipeline on one GPU.

PyTorch counterpart of ``examples/train_sac_bitmap_scale.py``, with its
flags, its CSV columns and its line per iteration.  256 x 256 lidar FILL
bitmaps -> CNN actor/critics -> 16-D path actions tracked by the MPC, for
dozens of envs at once (``agents.planning_env.PlanningEnv``, batched), with
a uint8 replay on the card.  A Python loop over ``--steps-per-iter``
replaces the JAX script's ``lax.scan``; done envs restart through
``PlanningEnv.reset_done``.  The CSV has JAX's columns, then the means of
``SAC.update``'s diagnostics (``agents.sac.UPDATE_DIAGNOSTICS``; 0 in the
warm-up iterations).  Each planning step launches the exact scan's
march kernel and the rasterizer's fill and segment kernels once.

Cuts against the JAX script, each also named in ``--help``:

- ``--map`` defaults to the packaged ``track_0019`` (the JAX default,
  ``example_map.yaml``, is not packaged); the start is the track's
  ``assets.waypoint_start_poses``;
- the JAX script staggers env e by 0.05 m x (e % 8) in x on the example map;
  here by the same distance back along the start's heading;
- ``--save`` and ``--resume`` name a checkpoint file (``utils.checkpoint``:
  the SAC modules and optimizers and the iteration; the replay is not
  saved, as in JAX), not a directory.

Usage:
    python -m red_gym_tpu_torch.examples.train_sac_bitmap_scale --iters 2 --steps-per-iter 4
    python -m red_gym_tpu_torch.examples.train_sac_bitmap_scale --envs 32 --iters 400 \\
        --steps-per-iter 16 --bitmap 128 --f32 --seed 0 --alpha 0.02 \\
        --log-csv docs/media/sac_torch_bitmap_curve.csv

It runs on the card ("cuda") unless ``--device cpu`` is given; there is no
fallback.
"""

import argparse
import os
import time
import types

import torch

from red_gym_tpu_torch import assets, env as envlib
from red_gym_tpu_torch.agents import planning_env as pe
from red_gym_tpu_torch.agents.sac import SAC, UPDATE_DIAGNOSTICS, ReplayBuffer
from red_gym_tpu_torch.config import SimConfig, resolve_device
from red_gym_tpu_torch.utils import checkpoint as ckpt
from red_gym_tpu_torch.utils.profiling import Metrics

STAGGER_M, STAGGER_ROWS = 0.05, 8
HEADER = "iter,env_steps,reward_mean,done_rate,actor_loss,secs"   # the JAX script's columns
METRICS = ("reward", "done", "actor_loss") + UPDATE_DIAGNOSTICS


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--envs", type=int, default=64)
    ap.add_argument("--iters", type=int, default=120)
    ap.add_argument("--steps-per-iter", type=int, default=32)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--updates-per-step", type=int, default=1)
    ap.add_argument("--capacity", type=int, default=25_000)
    ap.add_argument("--bitmap", type=int, default=256)
    ap.add_argument("--beams", type=int, default=1080)
    ap.add_argument("--warmup-iters", type=int, default=2,
                    help="iterations of random actions before updates start")
    ap.add_argument("--log-csv", type=str, default=None)
    ap.add_argument("--save", type=str, default=None,
                    help="checkpoint file, written after every iteration")
    ap.add_argument("--resume", type=str, default=None,
                    help="checkpoint file to resume the SAC state and iteration from")
    ap.add_argument("--map", type=str, default=None,
                    help="map yaml; default the packaged track_0019 (the JAX script's "
                         "example_map.yaml is not packaged); envs start on the map's "
                         "*_waypoints.csv raceline, staggered back along its heading")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reward-mode", choices=("sal", "fixed"), default="fixed",
                    help="'sal' reproduces the reference's world-coord-as-pixel reward "
                         "quirk (collision fires ~always once the car leaves the world "
                         "origin); 'fixed' uses the env's true collision flag + car-frame "
                         "centering — the trainable signal")
    ap.add_argument("--grad-clip", type=float, default=10.0,
                    help="global-norm gradient clip (0 disables; the plain-Adam "
                         "reference setup diverged to NaN at 64 envs)")
    ap.add_argument("--alpha", type=float, default=0.2,
                    help="SAC entropy coefficient. 0.2 is the reference's fixed value "
                         "(SAL.py:479); ~0.02 makes the task reward competitive with "
                         "the entropy bonus of the 16-D action for learning runs")
    ap.add_argument("--f32", action="store_true",
                    help="float32 CNN compute instead of bfloat16")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device; 'cuda' (the default) needs a GPU and does not "
                         "fall back to the CPU")
    args = ap.parse_args(argv)
    if args.updates_per_step < 1:
        ap.error("--updates-per-step must be >= 1")
    return args


def make_config(args) -> SimConfig:
    return SimConfig(num_agents=1, num_beams=args.beams, timestep=0.015, dtype="float32")


def start_poses(track: str, envs: int, dtype, device):
    """(E, 1, 3): the track's waypoint start, env e STAGGER_M x (e % 8)
    back along the start's heading."""
    start = torch.as_tensor(assets.waypoint_start_poses(track, 1), dtype=torch.float64)
    back = STAGGER_M * (torch.arange(envs, dtype=torch.float64) % STAGGER_ROWS)
    poses = start.expand(envs, 1, 3).clone()
    poses[:, 0, 0] -= back * torch.cos(start[0, 2])
    poses[:, 0, 1] -= back * torch.sin(start[0, 2])
    return poses.to(dtype=dtype, device=device)


def build(args, cfg: SimConfig | None = None):
    """The trainer of ``args`` on ``args.device`` (the card by default):
    env params, the planning env reset at the start poses, SAC and its
    state, the replay and the device generator, as attributes.  ``cfg``
    replaces the trainer's config."""
    device = resolve_device(args.device)
    cfg = cfg or make_config(args)
    track = args.map or assets.named_map_yaml("track_0019")
    params = envlib.make_params(cfg, track, ".png", device=device)
    pcfg = pe.default_plan_config(cfg.tdtype)._replace(bitmap_dims=(args.bitmap, args.bitmap))
    env = pe.PlanningEnv(cfg, params, pcfg, reward_mode=args.reward_mode, device=device)
    sac = SAC(obs_shape=(args.bitmap, args.bitmap), action_dim=pe.ACTION_DIM,
              alpha=args.alpha, grad_clip=args.grad_clip or None,
              compute_dtype=torch.float32 if args.f32 else torch.bfloat16, device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    ps = env.reset(start_poses(track, args.envs, cfg.tdtype, device), gen)
    return types.SimpleNamespace(
        args=args, cfg=cfg, device=device, env=env, sac=sac, gen=gen, ps=ps,
        sstate=sac.init(torch.Generator().manual_seed(args.seed + 1)),
        buf=ReplayBuffer.create(args.capacity, (args.bitmap, args.bitmap), pe.ACTION_DIM,
                                device=device))


def uniform_actions(n: int, gen: torch.Generator, device):
    """The warm-up's random actions: (n, ACTION_DIM) uniform on [-1, 1)."""
    return 2.0 * torch.rand((n, pe.ACTION_DIM), generator=gen, device=device) - 1.0


def iteration(t, do_update: bool):
    """``steps_per_iter`` planning steps of every env (random actions until
    the updates start), each pushed to the replay, done envs restarted,
    then ``updates_per_step`` SAC updates -> (metric sums, reset steps)."""
    args = t.args
    acc = Metrics.init(METRICS, device=t.device)
    reset_steps = 0
    for _ in range(args.steps_per_iter):
        bitmaps = t.ps.bitmap                                     # (E, H, W)
        if do_update:
            act = t.sac.select_action(t.sstate, bitmaps, t.gen)
        else:
            act = uniform_actions(args.envs, t.gen, t.device)
        ps2, bitmaps2, r, done, _ = t.env.step(t.ps, act, t.gen)
        t.buf.push_batch(bitmaps, act, r, bitmaps2, done)
        t.ps, reset_any = t.env.reset_done(ps2, done, t.gen)
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
    # --f32 means float32 convolutions; cuDNN would run them in TF32
    torch.backends.cudnn.allow_tf32 = False
    # a seed reproduces its run, as JAX's does: cuDNN's default convolution
    # backward sums in an order that changes from run to run
    torch.backends.cudnn.deterministic = True
    t = build(args)
    start_iter = 0
    if args.resume and os.path.isfile(args.resume):
        got = ckpt.restore(args.resume, like={"sstate": t.sstate, "it": 0})
        t.sstate, start_iter = got["sstate"], int(got["it"])
        print(f"resumed SAC params at iter {start_iter}")

    if args.log_csv and start_iter == 0:
        with open(args.log_csv, "w") as f:
            f.write(",".join((HEADER,) + METRICS[3:]) + "\n")
    for it in range(start_iter, args.iters):
        t0 = time.time()
        acc, _ = iteration(t, it >= args.warmup_iters)
        m = Metrics.means(acc)
        secs = time.time() - t0
        row = (it, (it + 1) * args.steps_per_iter * args.envs, m["reward"], m["done"],
               m["actor_loss"], round(secs, 2)) + tuple(m[k] for k in METRICS[3:])
        print("iter %d  env-steps %d  reward %.3f  done %.3f  aloss %.4f  %.1fs" % row[:6],
              flush=True)
        if args.log_csv:
            with open(args.log_csv, "a") as f:
                f.write(",".join(str(v) for v in row) + "\n")
        if args.save:
            ckpt.save(args.save, {"sstate": t.sstate, "it": it + 1})
    return t


if __name__ == "__main__":
    main()
