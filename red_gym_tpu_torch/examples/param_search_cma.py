"""CMA-ES lap-time parameter search with whole-population evaluation on the card.

PyTorch counterpart of ``examples/param_search_cma.py`` (the reference's
parameter-search experiment, examples/config_example_map.yaml:24-43: bounds
for mass/lf/tlad/vgain, optim_method 'CMA', popsize/budget): each CMA
generation races the ENTIRE population in one batched rollout (one env row
per candidate, its own VehicleParams + pure-pursuit tlad/vgain), instead of
one sequential rollout per candidate.

The reference's ``example_map.yaml`` is not packaged, so the race runs on a
packaged track (``--track``, default track_0019) from its first waypoint
(``assets.waypoint_start_poses``).

Usage:
    python -m red_gym_tpu_torch.examples.param_search_cma [--popsize 50] \
        [--generations 15] [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import torch

from red_gym_tpu_torch import assets
from red_gym_tpu_torch.agents import pure_pursuit as pp
from red_gym_tpu_torch.config import Integrator, SimConfig, resolve_device
from red_gym_tpu_torch.tuning import search


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--popsize", type=int, default=50)
    ap.add_argument("--generations", type=int, default=15)
    ap.add_argument("--steps", type=int, default=4500)
    ap.add_argument("--beams", type=int, default=64)
    ap.add_argument("--track", type=str, default="track_0019",
                    help="packaged track name or a map yaml path (its "
                         "_waypoints.csv beside it)")
    ap.add_argument("--device", type=str, default="cuda")
    return ap.parse_args(argv)


def make_config(beams: int) -> SimConfig:
    """The example's configuration: one car, RK4 at dt 0.01, the exact scan
    in float32 with 32 march iterations and no scan noise."""
    return SimConfig(num_agents=1, num_beams=beams, timestep=0.01,
                     integrator=Integrator.RK4, dtype="float32",
                     march_iters=32, scan_noise_std=0.0)


def track_paths(track: str) -> tuple[str, str]:
    """(map yaml, waypoint CSV) of a packaged track name or a yaml path."""
    yaml_path = track if track.endswith(".yaml") else assets.named_map_yaml(track)
    return yaml_path, assets.waypoints_csv(yaml_path)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = make_config(args.beams)
    yaml_path, csv = track_paths(args.track)
    wpts = pp.load_waypoints_csv(csv, dtype=torch.float32, device=device)

    t0 = time.time()
    best, best_f = search(cfg, yaml_path, wpts,
                          start_pose=assets.waypoint_start_poses(yaml_path, 1)[0],
                          popsize=args.popsize, generations=args.generations,
                          steps=args.steps, device=device)
    dt = time.time() - t0
    evals = args.popsize * args.generations
    print(f"best two-lap time: {best_f:.3f}s with {best}")
    print(f"{evals} full-rollout evaluations in {dt:.1f}s "
          f"({evals / dt:.1f} rollouts/s, {args.steps} steps each)")
    return best, best_f


if __name__ == "__main__":
    main()
