"""Held-out-track generalization study: PPO trained on a train split of the
packaged tracks, its mean policy evaluated on every track.

PyTorch counterpart of ``examples/generalization_study.py``, with its
flags, its split (the sorted packaged ``track_*.yaml``, the last
``--holdout`` held out), its printout and its CSV columns (track, split,
speed_mean, crash_rate, laps_mean).  Training is the multi-map PPO of
``agents.ppo`` on the train tracks stacked (env e on train track
e % M), over ``parallel.sharding``: one process on one card, or under
torchrun (``WORLD_SIZE`` > 1) each rank its rows of the envs, rank 0
printing and writing.  The evaluation rolls the mean policy from each track's
raceline start for ``--eval-steps`` steps without resets, envs grouped by
track, every track stacked.

After JAX's five columns the CSV has two diagnostics of each track's
evaluation, which draw nothing: at every forward crossing of the start line
by an ego (the line through the start pose, square to its heading, crossed
in the heading's direction), ``cross_lat_abs_mean`` is the mean |lateral
offset| from the start pose (m) and ``cross_out_of_band`` the share of
crossings farther to the side than the finish band reaches at the line,
``finish_band_halfwidth + sqrt(finish_dist2)`` (2.316 m), where the lap
logic counts no lap (NaN for a track without a crossing).  They tell a lap
lost to the band from a lap not driven.

The committed study's flags (docs/status.md):
    python -m red_gym_tpu_torch.examples.generalization_study --envs 4096 \\
        --iters 400 --eval-envs-per-track 4096 --eval-steps 3000 \\
        --log-csv docs/media/generalization_torch.csv
A smoke:
    python -m red_gym_tpu_torch.examples.generalization_study --iters 2 \\
        --envs 64 --eval-steps 40 --rt-stride 8 --device cpu
"""

from __future__ import annotations

import argparse
import csv
import math
import os
import time

import numpy as np
import torch

from red_gym_tpu_torch import assets, env as envlib, rollout
from red_gym_tpu_torch.agents.ppo import PPO, PPOConfig, progress_collision_reward
from red_gym_tpu_torch.config import Integrator, SimConfig, resolve_device
from red_gym_tpu_torch.parallel import distributed as pdist, sharding as sh

FIELDS = ["track", "split", "speed_mean", "crash_rate", "laps_mean", "cross_lat_abs_mean",
          "cross_out_of_band"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--rollout", type=int, default=32)
    ap.add_argument("--agents", type=int, default=2)
    ap.add_argument("--holdout", type=int, default=2,
                    help="number of tracks (from the end of the sorted list) "
                         "excluded from training")
    ap.add_argument("--eval-envs-per-track", type=int, default=128)
    ap.add_argument("--eval-steps", type=int, default=3000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-csv", type=str, default=None)
    ap.add_argument("--rt-stride", type=int, default=2,
                    help="range-texture pose stride (texture cell = stride * map "
                         "resolution); raise for cheap CPU smokes")
    ap.add_argument("--collision-penalty", type=float, default=10.0,
                    help="crash penalty in the PPO shaping (the committed study's 10)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device; 'cuda' (the default) needs a GPU and does "
                         "not fall back to the CPU")
    return ap.parse_args(argv)


def start_frame(states):
    """The ego's (longitudinal, lateral) offsets from its start pose, in the
    start's frame, as ``env._lap_done_update`` computes them -> two (E,)."""
    dxy = states.x[:, 0, 0:2] - states.start_pose[:, 0, 0:2]
    delta = (states.start_rot @ dxy[:, :, None])[:, :, 0]
    return delta[:, 0], delta[:, 1]


@torch.no_grad()
def evaluate(ppo: PPO, pstate, params, poses, map_idx, steps: int, seed: int):
    """Roll the mean policy ``steps`` steps from ``poses`` (this rank's
    rows) without resets -> per env (mean ego speed, crashed at some step,
    final ego laps, forward start-line crossings, the sum of their |lateral
    offsets|, those outside the finish band), each (E,) float64 on the
    host, every rank's rows gathered in order."""
    cfg = ppo.cfg
    gen = torch.Generator(device=poses.device).manual_seed(seed)
    e_n = poses.shape[0]
    zeros = lambda: torch.zeros(e_n, dtype=torch.float64, device=poses.device)  # noqa: E731
    vel_sum, crossings, lat_sum, outside = zeros(), zeros(), zeros(), zeros()
    crashed = torch.zeros(e_n, dtype=torch.bool, device=poses.device)
    with sh.env_draws(ppo.mesh, e_n):
        states, obs, *_ = rollout.batched_reset(cfg, params, poses, gen, map_idx=map_idx)
        lon, _ = start_frame(states)
        # how far to the side of the start the lap logic counts a crossing
        reach = cfg.finish_band_halfwidth + math.sqrt(cfg.finish_dist2)
        for _ in range(steps):
            mean, _, _ = pstate.policy(obs.scans[:, 0], obs.linear_vels_x[:, 0])
            act = ppo._env_actions(mean, obs, pstate.policy, map_idx=states.map_idx)
            states, obs, _, _, _ = envlib.step(cfg, params, states, act, gen)
            vel_sum += obs.linear_vels_x[:, 0]
            crashed |= obs.collisions[:, 0] > 0
            lon2, lat = start_frame(states)
            crossed = (lon < 0) & (lon2 >= 0)
            crossings += crossed
            lat_sum += torch.where(crossed, lat.abs(), 0.0)
            outside += crossed & (lat.abs() > reach)
            lon = lon2
    per_env = torch.stack([vel_sum / steps, crashed.double(),
                           states.lap_counts[:, 0].double(), crossings, lat_sum, outside],
                          dim=1)
    group = None if ppo.mesh is None else ppo.mesh.group
    return pdist.all_gather_rows(per_env, group).cpu().numpy().T


def main(argv=None):
    args = parse_args(argv)
    distributed = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if distributed:
        pdist.initialize(device=args.device)
        device = pdist.local_device(args.device)
    else:
        device = resolve_device(args.device)
    try:
        return run(args, device, distributed)
    finally:
        if distributed:
            pdist.shutdown()


def run(args, device, distributed: bool):
    """The study of ``main`` -> its CSV rows."""
    mesh = sh.make_env_mesh(device=str(device)) if distributed else None
    lead = mesh is None or mesh.rank == 0

    def say(*a):
        if lead:
            print(*a, flush=True)

    yamls = assets.packaged_tracks()
    if not len(yamls) > args.holdout >= 1:
        raise ValueError(f"--holdout {args.holdout} needs 1 <= holdout < {len(yamls)}")
    train_yamls = yamls[: len(yamls) - args.holdout]
    names = [os.path.basename(y)[: -len(".yaml")] for y in yamls]
    say(f"train tracks: {names[: len(train_yamls)]}")
    say(f"held-out tracks: {names[len(train_yamls):]}")

    cfg = SimConfig(num_agents=args.agents, num_beams=1080, timestep=0.01,
                    integrator=Integrator.RK4, dtype="float32", scan_mode="fast",
                    rt_pose_stride=args.rt_stride)

    def shard(params, poses, map_idx, n):
        if mesh is None:
            return params, poses, map_idx
        return (sh.shard_params(mesh, params), *sh.shard_envs(mesh, (poses, map_idx), n))

    # ---- train on the train split ----
    params_tr = envlib.make_multimap_params(cfg, train_yamls, device=device)
    starts_tr = torch.as_tensor(assets.start_pose_table(train_yamls, args.agents),
                                dtype=torch.float32, device=device)
    map_idx = (torch.arange(args.envs, device=device) % len(train_yamls)).to(torch.int32)
    params_tr, poses, map_idx = shard(params_tr, starts_tr[map_idx.long()], map_idx,
                                      args.envs)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    with sh.env_draws(mesh, poses.shape[0]):
        states, obs, *_ = rollout.batched_reset(cfg, params_tr, poses, gen, map_idx=map_idx)

    ppo = PPO(cfg, params_tr, PPOConfig(rollout_len=args.rollout),
              reward_fn=progress_collision_reward(collision_penalty=args.collision_penalty),
              mesh=mesh)
    pstate = ppo.init(torch.Generator().manual_seed(args.seed + 1))
    if mesh is not None:
        pstate = sh.replicate(mesh, pstate)

    spi = args.envs * args.rollout
    for it in range(args.iters):
        t0 = time.time()
        pstate, states, obs, m = ppo.train_step(pstate, states, obs)
        loss = float(m["loss"])
        say(f"iter {it}: loss={loss:.4f} speed={float(m['speed_mean']):.2f} "
            f"done={float(m['done_rate']):.3f} "
            f"({spi / (time.time() - t0):,.0f} env-steps/s)")
    del states, obs, params_tr

    # ---- evaluate per track (all tracks stacked; envs grouped by track) ----
    ntr, e = len(yamls), args.eval_envs_per_track
    params_all = envlib.make_multimap_params(cfg, yamls, device=device)
    starts_all = torch.as_tensor(assets.start_pose_table(yamls, args.agents),
                                 dtype=torch.float32, device=device)
    eval_idx = torch.arange(ntr, dtype=torch.int32, device=device).repeat_interleave(e)
    params_all, eval_poses, eval_idx = shard(params_all, starts_all[eval_idx.long()],
                                             eval_idx, ntr * e)
    speed, crash, laps, crossings, lat_sum, outside = evaluate(
        ppo, pstate, params_all, eval_poses, eval_idx, args.eval_steps, args.seed + 2)

    rows = []
    for t in range(ntr):
        sl = slice(t * e, (t + 1) * e)
        split = "train" if t < len(train_yamls) else "holdout"
        n_cross = float(crossings[sl].sum())
        rows.append({"track": names[t], "split": split,
                     "speed_mean": round(float(speed[sl].mean()), 3),
                     "crash_rate": round(float(crash[sl].mean()), 4),
                     "laps_mean": round(float(laps[sl].mean()), 3),
                     "cross_lat_abs_mean": round(float(lat_sum[sl].sum()) / n_cross, 4)
                     if n_cross else math.nan,
                     "cross_out_of_band": round(float(outside[sl].sum()) / n_cross, 4)
                     if n_cross else math.nan})
        say(f"{names[t]:>12} [{split:7}] speed {rows[-1]['speed_mean']:5.2f} "
            f"m/s  crash {rows[-1]['crash_rate']:.3f}  laps {rows[-1]['laps_mean']:.2f}  "
            f"start-line crossings {n_cross:.0f}, |lateral| "
            f"{rows[-1]['cross_lat_abs_mean']:.3f} m, {rows[-1]['cross_out_of_band']:.3f} "
            f"outside the band")

    tr = [r for r in rows if r["split"] == "train"]
    ho = [r for r in rows if r["split"] == "holdout"]
    ts = np.mean([r["speed_mean"] for r in tr])
    hs = np.mean([r["speed_mean"] for r in ho])
    say(f"train-split mean speed {ts:.2f} m/s; held-out {hs:.2f} m/s "
        f"({hs / ts:.0%} of train)")

    if args.log_csv and lead:
        os.makedirs(os.path.dirname(args.log_csv) or ".", exist_ok=True)
        with open(args.log_csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=FIELDS)
            w.writeheader()
            w.writerows(rows)
        say(f"wrote {args.log_csv}")
    return rows


if __name__ == "__main__":
    main()
