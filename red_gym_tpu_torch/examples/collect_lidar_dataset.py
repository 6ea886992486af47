"""Batched lidar dataset collector.

PyTorch counterpart of ``examples/collect_lidar_dataset.py`` (reference
collector: f1tenth_gym/examples/lidar.py:158-258, random spawns, random
actions, lidar -> 256x256 occupancy tensors saved as npz), batched: every
episode is an env of one batch on the card, stepped with the exact scan
(the march kernel) and rasterized there (``ops/rasterize.lidar_to_bitmap``:
the fill and segment kernels), then saved as one npz with the JAX script's
keys, shapes and dtypes.  The default map is the packaged track_0019 (the
reference's example map is not packaged).

Usage:
    python -m red_gym_tpu_torch.examples.collect_lidar_dataset --episodes 64 --steps 10
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from red_gym_tpu_torch import assets, env as envlib
from red_gym_tpu_torch.config import SimConfig, resolve_device
from red_gym_tpu_torch.ops.rasterize import lidar_to_bitmap, scans_to_legacy_tensors


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--episodes", type=int, default=64,
                    help="parallel episodes (envs)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", type=str, default="lidar_dataset.npz")
    ap.add_argument("--image-size", type=int, default=256)
    ap.add_argument("--map", type=str, default=assets.named_map_yaml("track_0019"))
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--legacy-npz", type=str, default=None,
                    help="also write an npz in the REFERENCE collector's "
                         "schema: single key 'data', (N, 256, 256) uint8 "
                         "occupancy tensors (f1tenth_gym/examples/"
                         "lidar.py:214-257 semantics)")
    return ap.parse_args(argv)


def random_spawns(tmap, n: int, seed: int = 0) -> np.ndarray:
    """(n, 3) spawns on free cells with 0.6 m to 8 m of clearance (a wall
    within 8 m, so the legacy tensors' 10 m box is not empty), random
    headings, from numpy's ``default_rng(seed)`` as the JAX script draws."""
    occ = tmap.occupancy.cpu().numpy()
    dt_np = tmap.dt.cpu().numpy()
    res = float(tmap.resolution)
    rng = np.random.default_rng(seed)
    spawns = []
    while len(spawns) < n:
        r, c = rng.integers(0, occ.shape[0]), rng.integers(0, occ.shape[1])
        if 0.6 < dt_np[r, c] < 8.0:
            spawns.append([c * res + float(tmap.orig_x),
                           r * res + float(tmap.orig_y),
                           rng.uniform(0, 2 * np.pi)])
    return np.asarray(spawns)


def collect(cfg, params, spawns, steps: int, image_size: int, seed: int = 2):
    """Reset every env at its spawn, then ``steps`` random steps (steer
    U(-0.4, 0.4), speed U(1, 5)) -> (bitmaps (T, E, H, W) uint8, scans (T,
    E, B), actions (T, E, 2)), on the params' device."""
    device = params.tmap.dt.device
    e_n = spawns.shape[0]
    gen = torch.Generator(device=device).manual_seed(seed)
    poses = torch.as_tensor(spawns, dtype=torch.float32, device=device)[:, None, :]
    state, obs, *_ = envlib.reset(cfg, params, poses, gen)
    dims = (image_size, image_size)
    bitmaps, scans, actions = [], [], []
    for _ in range(steps):
        u = torch.rand((2, e_n, 1), generator=gen, device=device)
        act = torch.stack([0.4 * (2.0 * u[0] - 1.0), 1.0 + 4.0 * u[1]], dim=-1)
        state, obs, *_ = envlib.step(cfg, params, state, act, gen)
        scan = obs.scans[:, 0]
        bitmaps.append(lidar_to_bitmap(scan, bg_color="black", draw_mode="FILL",
                                       output_image_dims=dims))
        scans.append(scan)
        actions.append(act[:, 0])
    return torch.stack(bitmaps), torch.stack(scans), torch.stack(actions)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = SimConfig(num_agents=1, num_beams=1080, timestep=0.01, dtype="float32")
    params = envlib.make_params(cfg, args.map, ".png", device=device)
    spawns = random_spawns(params.tmap, args.episodes)
    bitmaps, scans, actions = collect(cfg, params, spawns, args.steps, args.image_size)
    scans_np = scans.cpu().numpy().astype(np.float32)
    np.savez_compressed(
        args.out,
        bitmaps=bitmaps.cpu().numpy().astype(np.uint8),   # (T, E, H, W)
        scans=scans_np,                                    # (T, E, 1080)
        actions=actions.cpu().numpy().astype(np.float32),  # (T, E, 2)
        spawns=np.asarray(spawns, np.float32))
    print(f"wrote {args.out}: bitmaps {tuple(bitmaps.shape)}, scans {tuple(scans.shape)}")

    if args.legacy_npz:
        # episode-major ordering like the reference (all steps of episode 0,
        # then episode 1, ...)
        flat = scans_np.transpose(1, 0, 2).reshape(-1, scans_np.shape[-1])
        data = scans_to_legacy_tensors(flat)
        np.savez_compressed(args.legacy_npz, data=data)
        print(f"wrote {args.legacy_npz}: data {data.shape} {data.dtype} "
              f"(reference collector schema)")


if __name__ == "__main__":
    main()
