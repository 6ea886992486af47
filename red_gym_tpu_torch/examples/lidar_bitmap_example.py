"""Lidar bitmaps of the live scan while driving pure pursuit.

PyTorch counterpart of ``examples/lidar_bitmap_example.py`` (reference
demo examples/lidar_example.py): one car drives pure pursuit with the exact
scan, and every ``--every`` steps the scan is drawn as RAYS, POLYGON and
FILL bitmaps (``ops.rasterize.lidar_to_bitmap``: the fill and segment
kernels on the card) and written as PNGs with ``maps.loader.encode_png``
(no Pillow needed).

Cut against the JAX script: it drives the example map, which is not
packaged; here the packaged track_0019 from its first waypoint, along its
own raceline.  Frames go to ``--outdir`` (default ``lidar_bitmaps`` in the
working directory, where the JAX script writes under /tmp).

Usage:
    python -m red_gym_tpu_torch.examples.lidar_bitmap_example [--steps 400] \\
        [--every 100] [--outdir lidar_bitmaps] [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import torch

from red_gym_tpu_torch import assets, env as envlib
from red_gym_tpu_torch.agents import pure_pursuit as pp
from red_gym_tpu_torch.config import SimConfig, resolve_device
from red_gym_tpu_torch.maps.loader import encode_png
from red_gym_tpu_torch.ops.rasterize import lidar_to_bitmap

MODES = ("RAYS", "POLYGON", "FILL")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--every", type=int, default=100)
    ap.add_argument("--outdir", type=str, default="lidar_bitmaps")
    ap.add_argument("--map", type=str, default=assets.named_map_yaml("track_0019"))
    ap.add_argument("--device", type=str, default="cuda")
    return ap.parse_args(argv)


@torch.no_grad()
def main(argv=None):
    """-> [(step, scan (B,) on the host, {mode: uint8 image (H, W)})]."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.outdir, exist_ok=True)
    cfg = SimConfig(num_agents=1, num_beams=1080, timestep=0.01, dtype="float32")
    params = envlib.make_params(cfg, args.map, ".png", device=device)
    ppp = pp.make_params(pp.load_waypoints_csv(assets.waypoints_csv(args.map),
                                               dtype=torch.float32, device=device))
    start = torch.as_tensor(assets.waypoint_start_poses(args.map, 1),
                            dtype=torch.float32, device=device)[None]
    gen = torch.Generator(device=device).manual_seed(0)
    state, obs, *_ = envlib.reset(cfg, params, start, gen)

    frames = []
    for t in range(args.steps):
        speed, steer = pp.plan(obs.poses_x[0, 0], obs.poses_y[0, 0],
                               obs.poses_theta[0, 0], ppp)
        action = torch.stack([steer, speed])[None, None, :]
        state, obs, _, done, _ = envlib.step(cfg, params, state, action, gen)
        if t % args.every == 0:
            imgs = {m: lidar_to_bitmap(obs.scans[0, 0], bg_color="black", draw_mode=m)
                    .cpu().numpy() for m in MODES}
            for mode, img in imgs.items():
                encode_png(os.path.join(args.outdir, f"{mode.lower()}_{t:05d}.png"), img)
            frames.append((t, obs.scans[0, 0].cpu(), imgs))
            print(f"step {t}: wrote {len(imgs)} bitmaps", flush=True)
        if bool(done[0]):
            break
    print("frames in", args.outdir)
    return frames


if __name__ == "__main__":
    main()
