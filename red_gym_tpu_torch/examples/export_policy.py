"""Export a trained PPO racer as a deployable ``torch.export`` program (.pt2).

PyTorch counterpart of ``examples/export_policy.py``, the deployment
analogue of the reference's ``torch.save(actor.state_dict(),
"sac_actor.pth")`` (reference src/SAL.py:1017): the greedy inference head
(scan, vel) -> (steer, speed) with the trained weights inside is exported
ahead of time on ``--device`` and saved; the runtime that serves it needs
torch only, no red_gym_tpu_torch or checkpoint code.

    python -m red_gym_tpu_torch.examples.train_ppo --envs 4096 --iters 60 --save ppo_ckpt.pt
    python -m red_gym_tpu_torch.examples.export_policy --ckpt ppo_ckpt.pt --out racer.pt2
    # on the robot / server:
    python -m red_gym_tpu_torch.examples.export_policy --serve racer.pt2
    python -m red_gym_tpu_torch.examples.export_policy --race racer.pt2

``--race`` drives the loaded program closed-loop on a packaged track
(``--track``, default track_0019, which stands in for the unpackaged
example map), from its waypoint starts, against a slow cruising opponent.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from red_gym_tpu_torch import assets
from red_gym_tpu_torch.config import Integrator, resolve_device
from red_gym_tpu_torch.utils import export as ex


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", type=str, default=None,
                    help="checkpoint written by train_ppo --save; random-init "
                         "weights if omitted (smoke mode)")
    ap.add_argument("--out", type=str, default="racer.pt2")
    ap.add_argument("--beams", type=int, default=1080)
    ap.add_argument("--device", type=str, default="cuda",
                    help="device the program is exported for and served on")
    ap.add_argument("--serve", type=str, default=None,
                    help="load an exported program and time inference "
                         "instead of exporting")
    ap.add_argument("--batch", type=int, default=64,
                    help="--serve benchmark batch size")
    ap.add_argument("--race", type=str, default=None,
                    help="load an exported program and drive it closed-loop "
                         "in the simulator (artifact in, laps out)")
    ap.add_argument("--race-steps", type=int, default=3000)
    ap.add_argument("--track", type=str, default="track_0019")
    ap.add_argument("--scan-mode", type=str, default="fast",
                    choices=("fast", "exact"), help="--race's lidar")
    return ap.parse_args(argv)


def input_shapes(ep: torch.export.ExportedProgram) -> list[str]:
    """The user inputs' shapes, the batch by its symbol."""
    names = set(ep.graph_signature.user_inputs)
    return [str(tuple(n.meta["val"].shape)) for n in ep.graph.nodes
            if n.op == "placeholder" and n.name in names]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(path: str, batch: int, device: torch.device):
    """Load ``path`` and time 100 calls at ``batch``; returns the controls."""
    ep = ex.load_policy(path)
    racer = ep.module().to(device)
    print(f"loaded {path}: device={device}, in={input_shapes(ep)}")
    beams = int(next(n for n in ep.graph.nodes if n.op == "placeholder"
                     and n.name in set(ep.graph_signature.user_inputs)).meta["val"].shape[-1])
    rng = np.random.default_rng(0)
    scan = torch.as_tensor(rng.uniform(0, 30, (batch, beams)), dtype=torch.float32,
                           device=device)
    vel = torch.as_tensor(rng.uniform(0, 8, (batch,)), dtype=torch.float32, device=device)
    with torch.no_grad():
        out = racer(scan, vel)
        _sync(device)
        n = 100
        t0 = time.time()
        for _ in range(n):
            out = racer(scan, vel)
        _sync(device)
    dt = (time.time() - t0) / n
    print(f"controls[0] = {out[0].cpu().numpy()}; "
          f"{1e6 * dt:.0f} us/call at batch {batch} "
          f"({batch / dt:,.0f} agents/s)")
    return out


def race(path: str, steps: int, track: str, scan_mode: str, device: torch.device):
    """Drive the loaded program as the ego car for ``steps`` steps; returns
    (steps run, laps, mean speed, collision steps)."""
    from red_gym_tpu_torch import env as envlib

    racer = ex.load_policy(path).module().to(device)
    env = envlib.make(map=assets.named_map_yaml(track), map_ext=".png", num_agents=2,
                      timestep=0.01, integrator=Integrator.RK4, scan_mode=scan_mode,
                      device=device)
    obs, *_ = env.reset(assets.waypoint_start_poses(track, 2))
    speeds, crashes = [], 0
    t = 0
    with torch.no_grad():
        for t in range(steps):
            scan = torch.as_tensor(obs["scans"][0:1], dtype=torch.float32, device=device)
            vel = torch.as_tensor(obs["linear_vels_x"][0:1], dtype=torch.float32,
                                  device=device)
            ego = racer(scan, vel)[0].cpu().numpy()
            act = np.array([ego, [0.0, 2.0]])     # opponent: slow cruise
            obs, _, done, _ = env.step(act)
            speeds.append(float(obs["linear_vels_x"][0]))
            crashes += int(obs["collisions"][0])
            if done:
                break
    laps = int(obs["lap_counts"][0])
    print(f"raced {t + 1} steps: laps={laps}, "
          f"mean speed {np.mean(speeds):.2f} m/s, "
          f"collision steps {crashes}")
    return t + 1, laps, float(np.mean(speeds)), crashes


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.serve:
        return serve(args.serve, args.batch, device)
    if args.race:
        return race(args.race, args.race_steps, args.track, args.scan_mode, device)

    from red_gym_tpu_torch.agents import ppo as ppolib
    from red_gym_tpu_torch.utils import checkpoint as ckpt

    policy = ppolib.ScanPolicy(num_beams=args.beams)
    if args.ckpt:
        raw = ckpt.restore(args.ckpt)
        # train_ppo saves a PPOState (policy, optimizer, gen); accept either
        # that or a bare policy state_dict
        policy.load_state_dict(raw.get("policy", raw))
        print(f"restored weights from {args.ckpt}")
    else:
        policy.reset_parameters(torch.Generator().manual_seed(0))
        print("WARNING: no --ckpt given, exporting random-init weights")

    fn = ex.deterministic_ppo_control(policy, ppolib.PPOConfig())
    scan = torch.zeros((1, args.beams), dtype=torch.float32)
    vel = torch.zeros((1,), dtype=torch.float32)
    ep = ex.save_policy(args.out, fn, (scan, vel), device=device)
    size = os.path.getsize(args.out)
    print(f"exported {args.out}: {size / 1e6:.2f} MB, "
          f"device={device}, symbolic batch, "
          f"in={input_shapes(ep)}")
    return ep


if __name__ == "__main__":
    main()
