"""The reference's waypoint_follow main loop, ported with ONE import change.

PyTorch counterpart of ``examples/waypoint_follow_compat.py``.  The body
mirrors the reference script (examples/waypoint_follow.py:241-290): classic
gym.make with the f110 env id, 4-tuple reset(poses)/step, obs-dict field
access, a render callback, laptime accumulated from step rewards.  The only
framework change a reference user needs is the import marked below.

Environment: ``F110_MAP`` / ``F110_WPTS`` (default: the packaged
track_0019, which stands in for the unpackaged example map, started at its
first waypoint), ``F110_CPU`` (run on the CPU), ``F110_RENDER`` (draw with
the host viewer, matplotlib), ``F110_MAX_STEPS`` (default 300000).

    python -m red_gym_tpu_torch.examples.waypoint_follow_compat
"""

import os
import time

import numpy as np
import torch

# the one-line port: reference scripts say `import gym`
from red_gym_tpu_torch import gym_compat as gym
from red_gym_tpu_torch import assets
from red_gym_tpu_torch.config import Integrator
from red_gym_tpu_torch.agents import pure_pursuit as pp

MAP = os.environ.get("F110_MAP", assets.named_map_yaml("track_0019")[:-len(".yaml")])
WPTS = os.environ.get("F110_WPTS", assets.waypoints_csv("track_0019"))


def main():
    device = "cpu" if os.environ.get("F110_CPU") else "cuda"
    max_steps = int(os.environ.get("F110_MAX_STEPS", 300_000))
    work = {"tlad": 0.82461887897713965, "vgain": 1.375}
    w = np.loadtxt(WPTS, delimiter=";", comments="#")
    sx, sy = w[0, 1], w[0, 2]
    stheta = np.arctan2(w[1, 2] - w[0, 2], w[1, 1] - w[0, 1])

    wpts = pp.load_waypoints_csv(WPTS, dtype=torch.float32, device=device)
    planner = pp.make_params(wpts, tlad=work["tlad"], vgain=work["vgain"])

    def render_callback(viewer):
        viewer.draw_polyline(wpts[:, 0:2].cpu().numpy(), color="tab:green")

    env = gym.make("f110_gym:f110-v0", map=MAP, map_ext=".png",
                   num_agents=1, timestep=0.01, integrator=Integrator.RK4,
                   device=device)
    if os.environ.get("F110_RENDER"):
        env.add_render_callback(render_callback)

    obs, step_reward, done, _ = env.reset(np.array([[sx, sy, stheta]]))

    def t(v):
        return torch.as_tensor(v, dtype=torch.float32, device=device)

    laptime = 0.0
    start = time.time()
    steps = 0
    while not done and steps < max_steps:
        speed, steer = pp.plan(t(obs["poses_x"][0]), t(obs["poses_y"][0]),
                               t(obs["poses_theta"][0]), planner)
        obs, step_reward, done, info = env.step(
            np.array([[float(steer), float(speed)]]))
        laptime += step_reward
        steps += 1
        if os.environ.get("F110_RENDER"):
            env.render(mode="human_fast")

    print("Sim elapsed time:", laptime,
          "Real elapsed time:", time.time() - start)
    return laptime, steps


if __name__ == "__main__":
    main()
