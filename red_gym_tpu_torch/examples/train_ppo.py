"""PPO on one GPU: thousands of envs stepped and learned from on the card.

PyTorch counterpart of ``examples/train_ppo.py``, with its flags, its CSV
columns and its line per iteration.  Cuts against it, each also named in
``--help``:

- no mesh: one card needs none (the JAX script shards envs over a mesh);
- ``--map`` defaults to the packaged ``track_0019`` (the JAX default,
  ``example_map.yaml``, is not packaged); cars start on its raceline
  (``assets.waypoint_start_poses``);
- ``--opponents pursuit`` follows the track's own ``*_waypoints.csv``;
- ``--multi-map`` stacks the 11 packaged tracks;
- ``--save`` names a checkpoint file (``utils.checkpoint``), not a directory.

Usage:
    python -m red_gym_tpu_torch.examples.train_ppo --envs 1024 --iters 20
    python -m red_gym_tpu_torch.examples.train_ppo --envs 16384 --iters 100 \\
        --seed 0 --log-csv docs/media/ppo_torch_seed0.csv

It runs on the card ("cuda") unless ``--device cpu`` is given; there is no
fallback.  ``--profile`` adds a torch.profiler table of one iteration by
section (ppo/policy, ppo/env_step, ppo/opponents, ppo/reset, ppo/update).
"""

import argparse
import dataclasses
import time

import torch

from red_gym_tpu_torch import assets, env as envlib, rollout
from red_gym_tpu_torch.agents.ppo import PPO, PPOConfig
from red_gym_tpu_torch.config import Integrator, SimConfig, resolve_device
from red_gym_tpu_torch.utils import checkpoint as ckpt

SECTIONS = ("ppo/policy", "ppo/env_step", "ppo/opponents", "ppo/reset", "ppo/update")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--rollout", type=int, default=32)
    ap.add_argument("--agents", type=int, default=2)
    ap.add_argument("--beams", type=int, default=1080)
    ap.add_argument("--scan-mode", type=str, default="fast", choices=["exact", "fast"])
    ap.add_argument("--rt-spatial", type=str, default="bilinear",
                    choices=["bilinear", "nearest", "nearest1"],
                    help="fast-scan spatial lookup; nearest1 = the single-gather "
                         "ultra-throughput mode")
    ap.add_argument("--ultra", action="store_true",
                    help="train on the spectral ultra-throughput scan (nearest1 + "
                         "spectral interpolation, no edge/grad channels); the default "
                         "trains on the accuracy-first edge+grad scan")
    ap.add_argument("--save", type=str, default="ppo_ckpt.pt",
                    help="checkpoint file (the JAX script's is an orbax directory)")
    ap.add_argument("--map", type=str, default=None,
                    help="map yaml; default the packaged track_0019 (the JAX script's "
                         "example_map.yaml is not packaged); cars start on the map's "
                         "*_waypoints.csv raceline")
    ap.add_argument("--opponents", type=str, default="cruise",
                    choices=["cruise", "pursuit", "self"],
                    help="non-ego agents hold slow-straight, track the map's own "
                         "*_waypoints.csv raceline with pure pursuit, or mirror the "
                         "learning policy (self-play)")
    ap.add_argument("--multi-map", action="store_true",
                    help="train across the 11 packaged tracks: per-env map assignment "
                         "into shared stacked textures")
    ap.add_argument("--resume", action="store_true",
                    help="restore trainer state from --save if present")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint every N iterations (0 = only at end)")
    ap.add_argument("--eval", action="store_true",
                    help="no training: load --save and roll the mean policy, "
                         "reporting laps/speed/crashes")
    ap.add_argument("--eval-steps", type=int, default=6000)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed for env resets and policy init")
    ap.add_argument("--log-csv", type=str, default=None,
                    help="write per-iteration metrics (iter, env_steps, loss, "
                         "reward_mean, done_rate, speed_mean, wall_s) to this CSV")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device; 'cuda' (the default) needs a GPU and does not "
                         "fall back to the CPU. No mesh: the JAX script's env mesh "
                         "has no counterpart on one card")
    ap.add_argument("--profile", action="store_true",
                    help="profile the second iteration by section (torch.profiler)")
    return ap.parse_args(argv)


def make_config(args) -> SimConfig:
    cfg = SimConfig(num_agents=args.agents, num_beams=args.beams, timestep=0.01,
                    integrator=Integrator.RK4, dtype="float32",
                    scan_mode=args.scan_mode, rt_spatial=args.rt_spatial)
    if args.ultra:
        cfg = dataclasses.replace(cfg, rt_spatial="nearest1", scan_interp="spectral",
                                  rt_grad=False, rt_occlusion="off")
    return cfg


def make_envs(cfg: SimConfig, args, device):
    """-> (env params, start poses (E, A, 3), map_idx (E,) or None, the
    tracks' yaml paths)."""
    if args.multi_map:
        tracks = assets.packaged_tracks()
        params = envlib.make_multimap_params(cfg, tracks, device=device)
        map_idx = (torch.arange(args.envs, device=device) % len(tracks)).to(torch.int32)
        table = torch.as_tensor(assets.start_pose_table(tracks, args.agents),
                                dtype=cfg.tdtype, device=device)
        print(f"multi-map: {len(tracks)} tracks, per-env assignment", flush=True)
        return params, table[map_idx.long()], map_idx, tracks
    track = args.map or assets.named_map_yaml("track_0019")
    params = envlib.make_params(cfg, track, ".png", device=device)
    start = torch.as_tensor(assets.waypoint_start_poses(track, args.agents),
                            dtype=cfg.tdtype, device=device)
    return params, start.expand(args.envs, args.agents, 3).contiguous(), None, [track]


def opponent_hook(args, tracks, device):
    if args.opponents == "self":
        return "self"
    if args.opponents != "pursuit" or args.agents < 2:
        return None
    from red_gym_tpu_torch.agents import pure_pursuit as pp
    from red_gym_tpu_torch.agents.ppo import (pure_pursuit_opponents,
                                              pure_pursuit_opponents_multi)

    ppps = [pp.make_params(pp.load_waypoints_csv(assets.waypoints_csv(t),
                                                 dtype=torch.float32, device=device))
            for t in tracks]
    if args.multi_map:
        return pure_pursuit_opponents_multi(pp.stack_params(ppps))
    return pure_pursuit_opponents(ppps[0])


@torch.no_grad()
def evaluate(ppo: PPO, pstate, states, obs, steps: int):
    """Roll the mean policy ``steps`` steps without resets -> (mean ego
    speed, share of envs whose ego collided at some step, mean final laps)."""
    cfg, gen = ppo.cfg, pstate.gen
    vel_sum = torch.zeros((), dtype=torch.float64, device=obs.scans.device)
    crashed = torch.zeros(obs.scans.shape[0], dtype=torch.bool, device=obs.scans.device)
    for _ in range(steps):
        mean, _, _ = pstate.policy(obs.scans[:, 0], obs.linear_vels_x[:, 0])
        act = ppo._env_actions(mean, obs, pstate.policy, map_idx=states.map_idx)
        states, obs, _, _, _ = envlib.step(cfg, ppo.env_params, states, act, gen)
        vel_sum += obs.linear_vels_x[:, 0].sum()
        crashed |= obs.collisions[:, 0] > 0
    e_n = obs.scans.shape[0]
    return (float(vel_sum) / (steps * e_n), float(crashed.float().mean()),
            float(states.lap_counts[:, 0].float().mean()))


def profile_iteration(ppo: PPO, pstate, states, obs):
    """One train_step under torch.profiler.  For each section (the ranges
    ppo.py records): its host ms (the ranges' wall time on the host), its
    device busy ms (the kernels launched inside it) and, on the card, its
    device span ms (first to last of its work on the stream)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if obs.scans.is_cuda:
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        out = ppo.train_step(pstate, states, obs)
        float(out[3]["loss"])
    wall = 1e3 * (time.perf_counter() - t0)
    host, busy, span, calls = ({n: 0.0 for n in SECTIONS} for _ in range(4))
    for e in prof.events():
        if e.name not in host:
            continue
        if e.device_type == DeviceType.CPU:
            host[e.name] += e.cpu_time_total / 1e3
            busy[e.name] += e.device_time_total / 1e3
            calls[e.name] += 1
        else:
            span[e.name] += e.time_range.elapsed_us() / 1e3
    parts = [f"{n} host {host[n]:.1f} ms, device busy {busy[n]:.1f} ms, span "
             f"{span[n]:.1f} ms ({calls[n]:.0f} calls)" for n in SECTIONS if calls[n]]
    print(f"[profile] one iteration {wall:.1f} ms under the profiler: " + "; ".join(parts),
          flush=True)
    return out


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = make_config(args)
    params, poses, map_idx, tracks = make_envs(cfg, args, device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    states, obs, *_ = rollout.batched_reset(cfg, params, poses, gen, map_idx=map_idx)

    ppo = PPO(cfg, params, PPOConfig(rollout_len=args.rollout),
              opponent_plan=opponent_hook(args, tracks, device))
    pstate = ppo.init(torch.Generator().manual_seed(args.seed + 1))
    if args.resume or args.eval:
        try:
            pstate = ckpt.restore(args.save, like=pstate)
            print(f"restored trainer state from {args.save}", flush=True)
        except FileNotFoundError:
            pass

    if args.eval:
        speed, crash, laps = evaluate(ppo, pstate, states, obs, args.eval_steps)
        print(f"eval over {args.envs} envs x {args.eval_steps} steps "
              f"({args.eval_steps * cfg.timestep:.0f}s sim):")
        print(f"  mean speed {speed:.2f} m/s   crash rate {crash:.3f}   "
              f"final laps (mean) {laps:.2f}", flush=True)
        return

    csv_f = None
    if args.log_csv:
        csv_f = open(args.log_csv, "w")
        csv_f.write("iter,env_steps,loss,reward_mean,done_rate,speed_mean,wall_s\n")
    try:
        steps_per_iter = args.envs * args.rollout
        t_start = time.time()
        for it in range(args.iters):
            t0 = time.time()
            if args.profile and it == 1:
                pstate, states, obs, metrics = profile_iteration(ppo, pstate, states, obs)
            else:
                pstate, states, obs, metrics = ppo.train_step(pstate, states, obs)
            loss = float(metrics["loss"])  # also waits for the device
            dt = time.time() - t0
            print(f"iter {it}: loss={loss:.4f} "
                  f"reward={float(metrics['reward_mean']):.4f} "
                  f"done_rate={float(metrics['done_rate']):.3f} "
                  f"speed={float(metrics['speed_mean']):.2f} "
                  f"({steps_per_iter / dt:,.0f} env-steps/s)", flush=True)
            if csv_f:
                csv_f.write(f"{it},{(it + 1) * steps_per_iter},{loss:.6f},"
                            f"{float(metrics['reward_mean']):.6f},"
                            f"{float(metrics['done_rate']):.6f},"
                            f"{float(metrics['speed_mean']):.4f},"
                            f"{time.time() - t_start:.2f}\n")
                csv_f.flush()
            if args.ckpt_every and (it + 1) % args.ckpt_every == 0:
                ckpt.save(args.save, pstate)
    finally:
        if csv_f:
            csv_f.close()

    ckpt.save(args.save, pstate)
    print(f"saved {args.save}", flush=True)


if __name__ == "__main__":
    main()
