"""PPO on one GPU or data-parallel over several: thousands of envs stepped
and learned from on the card.

PyTorch counterpart of ``examples/train_ppo.py``, with its flags, its CSV
columns and its line per iteration.  The JAX script shards envs over a
device mesh; here one process trains on one card, and under torchrun
(``WORLD_SIZE`` > 1) each rank takes its rows of the ``--envs`` envs
(``parallel.sharding``), the learner is replicated and every update
all-reduces its gradients (``agents.ppo``); rank 0 logs.  Cuts against the
JAX script, each also named in ``--help``:

- ``--map`` defaults to the packaged ``track_0019`` (the JAX default,
  ``example_map.yaml``, is not packaged); cars start on its raceline
  (``assets.waypoint_start_poses``);
- ``--opponents pursuit`` follows the track's own ``*_waypoints.csv``;
- ``--multi-map`` stacks the 11 packaged tracks;
- ``--save`` names a checkpoint file of the trainer state
  (``utils.checkpoint.save``), not a directory.  Under torchrun it names a
  directory where every rank writes its shard, env states included
  (``utils.checkpoint.save_shards``); ``--resume`` then restarts every rank
  from the last complete step and runs on to ``--iters``, so a job that
  torchrun restarts with the same command finishes the run it began, as
  if it had never stopped.  One process resumes as the JAX script does:
  the trainer state, fresh envs and ``--iters`` more iterations.

Usage:
    python -m red_gym_tpu_torch.examples.train_ppo --envs 1024 --iters 20
    python -m red_gym_tpu_torch.examples.train_ppo --envs 16384 --iters 100 \\
        --seed 0 --log-csv docs/media/ppo_torch_seed0.csv
    torchrun --nproc-per-node=2 -m red_gym_tpu_torch.examples.train_ppo \\
        --envs 32768 --iters 100

It runs on the card ("cuda") unless ``--device cpu`` is given; there is no
fallback.  ``--profile`` adds a torch.profiler table of one iteration by
section (ppo/policy, ppo/env_step, ppo/opponents, ppo/reset, ppo/update),
the envs that iteration restarted, and the set-up spans' seconds (params,
maps, EDTs, textures; ``utils/profiling``).
"""

import argparse
import dataclasses
import os
import time

import torch

from red_gym_tpu_torch import assets, env as envlib, rollout
from red_gym_tpu_torch.agents.ppo import DIAGNOSTICS, PPO, PPOConfig
from red_gym_tpu_torch.config import Integrator, SimConfig, resolve_device
from red_gym_tpu_torch.parallel import distributed as pdist, draws, sharding as sh
from red_gym_tpu_torch.utils import checkpoint as ckpt, profiling

# JAX's seven columns (examples/train_ppo.py), then the update's diagnostics
CSV_COLUMNS = ("iter", "env_steps", "loss", "reward_mean", "done_rate", "speed_mean",
               "wall_s") + DIAGNOSTICS
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
    ap.add_argument("--save", type=str, default=None,
                    help="checkpoint file, default ppo_ckpt.pt (the JAX script's is an "
                         "orbax directory); under torchrun the ranks' shard "
                         "directory, default ppo_ckpt")
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
                    help="restore trainer state from --save if present; under "
                         "torchrun also the env states, and go on from the saved "
                         "iteration to --iters")
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
                         "reward_mean, done_rate, speed_mean, wall_s, then the update's "
                         "diagnostics approx_kl, clip_frac, log_std_0, log_std_1, "
                         "value_loss, grad_norm) to this CSV")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device; 'cuda' (the default) needs a GPU and does not "
                         "fall back to the CPU. Under torchrun each rank takes "
                         "cuda:LOCAL_RANK")
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
    speed, share of envs whose ego collided at some step, mean final laps),
    over every rank's envs on a mesh."""
    cfg, gen = ppo.cfg, pstate.gen
    dev = obs.scans.device
    vel_sum = torch.zeros((), dtype=torch.float64, device=dev)
    crashed = torch.zeros(obs.scans.shape[0], dtype=torch.bool, device=dev)
    with sh.env_draws(ppo.mesh, obs.scans.shape[0]):
        for _ in range(steps):
            mean, _, _ = pstate.policy(obs.scans[:, 0], obs.linear_vels_x[:, 0])
            act = ppo._env_actions(mean, obs, pstate.policy, map_idx=states.map_idx)
            states, obs, _, _, _ = envlib.step(cfg, ppo.env_params, states, act, gen)
            vel_sum += obs.linear_vels_x[:, 0].sum()
            crashed |= obs.collisions[:, 0] > 0
    sums = torch.stack([vel_sum, crashed.double().sum(),
                        states.lap_counts[:, 0].double().sum(),
                        torch.tensor(float(obs.scans.shape[0]), dtype=torch.float64,
                                     device=dev)])
    if ppo.mesh is not None:
        sums = draws.all_reduce_sum(sums, ppo.mesh.group)
    vel, crash, laps, e_n = sums.tolist()
    return vel / (steps * e_n), crash / e_n, laps / e_n


def profile_iteration(ppo: PPO, pstate, states, obs):
    """One train_step under torch.profiler.  For each section (the ranges
    ppo.py records): its host ms (the ranges' wall time on the host), its
    device busy ms (the kernels launched inside it) and, on the card, its
    device span ms (first to last of its work on the stream).  Then the
    envs the iteration restarted (counter ``rollout/restarted_envs``) and
    the set-up spans so far."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if obs.scans.is_cuda:
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    restarted = profiling.counter_totals().get("rollout/restarted_envs", 0)
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
    restarted = profiling.counter_totals().get("rollout/restarted_envs", 0) - restarted
    setup = [f"{n} {v['seconds']:.3f} s ({v['count']} calls)"
             for n, v in profiling.span_totals().items()]
    print(f"[profile] envs restarted in the iteration: {restarted}; set-up: "
          + "; ".join(setup), flush=True)
    return out


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
    """The trainer of ``main`` on ``device``; on a mesh of the process
    group when ``distributed`` -> (pstate, each iteration's metrics as
    floats with its wall seconds under "wall_s"; empty under --eval)."""
    mesh = sh.make_env_mesh(device=str(device)) if distributed else None
    lead = mesh is None or mesh.rank == 0

    def say(*a, **kw):
        if lead:
            print(*a, **kw, flush=True)

    cfg = make_config(args)
    params, poses, map_idx, tracks = make_envs(cfg, args, device)
    if mesh is not None:
        params = sh.shard_params(mesh, params)
        poses, map_idx = sh.shard_envs(mesh, (poses, map_idx), args.envs)
        say(f"distributed: {mesh.world_size} ranks x {poses.shape[0]} envs")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    with sh.env_draws(mesh, poses.shape[0]):
        states, obs, *_ = rollout.batched_reset(cfg, params, poses, gen, map_idx=map_idx)

    ppo = PPO(cfg, params, PPOConfig(rollout_len=args.rollout),
              opponent_plan=opponent_hook(args, tracks, device), mesh=mesh)
    pstate = ppo.init(torch.Generator().manual_seed(args.seed + 1))
    save = args.save or ("ppo_ckpt.pt" if mesh is None else "ppo_ckpt")
    start = 0
    if mesh is not None:
        pstate = sh.replicate(mesh, pstate)
        if (args.resume or args.eval) and os.path.exists(os.path.join(save, "STEP")):
            tree, step = ckpt.restore_shards(
                save, like={"pstate": pstate, "states": states, "obs": obs}, mesh=mesh)
            pstate = tree["pstate"]
            if not args.eval:   # the evaluation starts its envs afresh
                start, states, obs = step, tree["states"], tree["obs"]
            say(f"restored {mesh.world_size} ranks' state of iteration {step} from {save}")
    elif args.resume or args.eval:
        try:
            pstate = ckpt.restore(save, like=pstate)
            say(f"restored trainer state from {save}")
        except FileNotFoundError:
            pass

    def checkpoint(iters_done: int) -> None:
        if mesh is None:
            ckpt.save(save, pstate)
        else:   # every rank writes its shard
            ckpt.save_shards(save, {"pstate": pstate, "states": states, "obs": obs},
                             iters_done, mesh)

    if args.eval:
        speed, crash, laps = evaluate(ppo, pstate, states, obs, args.eval_steps)
        say(f"eval over {args.envs} envs x {args.eval_steps} steps "
            f"({args.eval_steps * cfg.timestep:.0f}s sim):")
        say(f"  mean speed {speed:.2f} m/s   crash rate {crash:.3f}   "
            f"final laps (mean) {laps:.2f}")
        return pstate, []

    history = []
    csv_f = None
    if args.log_csv and lead:
        csv_f = open(args.log_csv, "w")
        csv_f.write(",".join(CSV_COLUMNS) + "\n")
    try:
        steps_per_iter = args.envs * args.rollout
        t_start = time.time()
        for it in range(start, args.iters):
            t0 = time.time()
            if args.profile and it == 1:
                pstate, states, obs, metrics = profile_iteration(ppo, pstate, states, obs)
            else:
                pstate, states, obs, metrics = ppo.train_step(pstate, states, obs)
            loss = float(metrics["loss"])  # also waits for the device
            dt = time.time() - t0
            history.append({**{k: float(v) for k, v in metrics.items()}, "wall_s": dt})
            say(f"iter {it}: loss={loss:.4f} "
                f"reward={float(metrics['reward_mean']):.4f} "
                f"done_rate={float(metrics['done_rate']):.3f} "
                f"speed={float(metrics['speed_mean']):.2f} "
                f"({steps_per_iter / dt:,.0f} env-steps/s)")
            if csv_f:
                csv_f.write(f"{it},{(it + 1) * steps_per_iter},{loss:.6f},"
                            f"{float(metrics['reward_mean']):.6f},"
                            f"{float(metrics['done_rate']):.6f},"
                            f"{float(metrics['speed_mean']):.4f},"
                            f"{time.time() - t_start:.2f},"
                            + ",".join(f"{float(metrics[k]):.6g}" for k in DIAGNOSTICS)
                            + "\n")
                csv_f.flush()
            if args.ckpt_every and (it + 1) % args.ckpt_every == 0:
                checkpoint(it + 1)
    finally:
        if csv_f:
            csv_f.close()

    checkpoint(max(start, args.iters))
    say(f"saved {save}")
    return pstate, history


if __name__ == "__main__":
    main()
