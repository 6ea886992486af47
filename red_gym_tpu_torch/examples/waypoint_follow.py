"""Pure-pursuit waypoint following on a packaged track.

PyTorch counterpart of ``examples/waypoint_follow.py`` (reference demo,
examples/waypoint_follow.py:241-290): the closed loop, planner + simulator,
runs on the card, one ``env.step`` a Python loop iteration (where JAX scans
the loop on the device); the trajectory is (optionally) drawn on the host
with matplotlib (``render/viewer.plot_trajectory``; the card's machine has
no matplotlib, so ``--render`` is for a workstation).
The default track is the packaged track_0019 (the reference's example map
is not packaged), started at its first waypoint facing along the raceline.

Usage:
    python -m red_gym_tpu_torch.examples.waypoint_follow [--steps 6000] \
        [--render out.png] [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from red_gym_tpu_torch import assets, env as envlib
from red_gym_tpu_torch.agents import pure_pursuit as pp
from red_gym_tpu_torch.config import Integrator, SimConfig, resolve_device


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--map", type=str, default=assets.named_map_yaml("track_0019"))
    ap.add_argument("--waypoints", type=str, default=None,
                    help="raceline CSV (default: the map's _waypoints.csv)")
    ap.add_argument("--render", type=str, default="",
                    help="write a trajectory plot to this png path")
    ap.add_argument("--device", type=str, default="cuda")
    return ap.parse_args(argv)


def rollout(cfg, params, ppp, start, steps: int, seed: int = 12345):
    """``steps`` closed-loop steps from ``start`` (1, 1, 3) -> (xs, ys,
    dones), each (steps,) numpy."""
    gen = torch.Generator(device=start.device).manual_seed(seed)
    state, obs, *_ = envlib.reset(cfg, params, start, gen)
    xs, ys, dones = [], [], []
    for _ in range(steps):
        speed, steer = pp.plan(obs.poses_x[0, 0], obs.poses_y[0, 0],
                               obs.poses_theta[0, 0], ppp)
        action = torch.stack([steer, speed])[None, None, :]
        state, obs, _, done, _ = envlib.step(cfg, params, state, action, gen)
        xs.append(obs.poses_x[0, 0])
        ys.append(obs.poses_y[0, 0])
        dones.append(done[0])
    return (torch.stack(xs).cpu().numpy(), torch.stack(ys).cpu().numpy(),
            torch.stack(dones).cpu().numpy())


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    csv = args.waypoints or assets.waypoints_csv(args.map)
    cfg = SimConfig(num_agents=1, num_beams=1080, timestep=0.01,
                    integrator=Integrator.RK4, dtype="float32")
    params = envlib.make_params(cfg, args.map, ".png", device=device)
    wpts = pp.load_waypoints_csv(csv, dtype=torch.float32, device=device)
    ppp = pp.make_params(wpts)
    w = np.loadtxt(csv, delimiter=";", comments="#")
    start = torch.tensor([[[w[0, 1], w[0, 2],
                            np.arctan2(w[1, 2] - w[0, 2], w[1, 1] - w[0, 1])]]],
                         dtype=torch.float32, device=device)

    def timed():
        t0 = time.time()
        out = rollout(cfg, params, ppp, start, args.steps)
        return out, time.time() - t0

    # the first run also builds the kernels, as JAX's first call compiles
    (xs, ys, dones), first = timed()
    _, run = timed()

    done_step = int(np.argmax(dones)) if dones.any() else args.steps
    sim_time = (done_step + 2) * cfg.timestep  # +2: reset consumed one step
    print(f"backend={device.type} steps={args.steps}")
    print(f"Sim elapsed time: {sim_time if dones.any() else float('nan')} "
          f"(two laps done: {bool(dones.any())})")
    print(f"Real elapsed time: {run:.3f}s ({args.steps / run:.0f} steps/s; "
          f"first call incl. compile {first:.1f}s)")

    if args.render:
        from red_gym_tpu_torch.render.viewer import plot_trajectory

        n = done_step if dones.any() else args.steps
        name = args.map.rsplit("/", 1)[-1][:-len(".yaml")]
        plot_trajectory(params.tmap, xs[:n], ys[:n], args.render,
                        f"pure pursuit on {name}")
        print("wrote", args.render)
    return sim_time, bool(dones.any())


if __name__ == "__main__":
    main()
