"""Fast-scan error study: the fast scan's error against the exact float64
march at the shipped texture settings, for each occlusion / gradient
channel / cell lookup / theta interpolation mode.

PyTorch counterpart of ``examples/scan_error_study.py``, with its JSON row
per (occlusion, grad, spatial, interp) combination: median / p90 / p99 /
max error and the shares of beams off by more than 1 and 4 texture cells.
The oracle is the exact march in float64 (reference
gym/f110_gym/envs/laser_models.py:107-146): on the card the march kernel's
double instance, on the CPU its twin.  The fast scans run in float32
through ``scan_fast.trace_fast_mxu``: on the card the edge render (kernel
6), the plain 3-tap blend (kernel 7), the eager snap epilogue and the plain
spectral product.  The float32 matrix products run at full precision
(``torch.set_float32_matmul_precision("highest")``), as the unfused branch
requires.

The JAX script builds a texture for each channel set; here one texture
with every channel [R | e w | gx gy] is built and each mode reads its
columns (the build computes each channel the same way whatever the
others).  ``--rt-stride`` (default the shipped 2) cuts the build for CPU
smokes.

Usage:
    python -m red_gym_tpu_torch.examples.scan_error_study [--map track_wide] \\
        [--poses 64] [--seed 0] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from red_gym_tpu_torch import assets
from red_gym_tpu_torch.config import SimConfig, resolve_device
from red_gym_tpu_torch.maps.loader import load_map
from red_gym_tpu_torch.ops import scan as scan_ops, scan_fast

COMBOS = [("edge", True), ("edge", False), ("snap", False), ("off", True), ("off", False)]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--map", default="track_wide")
    ap.add_argument("--poses", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rt-stride", type=int, default=SimConfig.rt_pose_stride,
                    help="range-texture pose stride; raise for cheap CPU smokes")
    ap.add_argument("--device", type=str, default="cuda")
    return ap.parse_args(argv)


def sample_poses(tmap64, n, rng, min_clearance=0.3):
    """(n, 3) numpy poses at the centres of free cells at least
    ``min_clearance`` m from a wall, random headings (the JAX script's)."""
    dt_np = tmap64.dt.cpu().numpy()
    res = float(tmap64.resolution)
    poses = []
    while len(poses) < n:
        r = rng.integers(0, dt_np.shape[0])
        c = rng.integers(0, dt_np.shape[1])
        if dt_np[r, c] > min_clearance:
            poses.append([c * res + float(tmap64.orig_x) + res / 2,
                          r * res + float(tmap64.orig_y) + res / 2,
                          rng.uniform(0, 2 * np.pi)])
    return np.asarray(poses)


def _columns(rtex, t_bins: int, occlusion: str, grad: bool):
    """The texture with the channels of a mode: columns of [R | e w | gx gy]."""
    cols = [slice(0, t_bins)]
    if occlusion == "edge":
        cols.append(slice(t_bins, 3 * t_bins))
    if grad:
        cols.append(slice(3 * t_bins, 5 * t_bins))
    return rtex._replace(rt=torch.cat([rtex.rt[:, c] for c in cols], dim=1))


def error_row(exact, fast, cell: float, **mode) -> dict:
    err = np.abs(exact - fast)
    return {**mode,
            "median": round(float(np.median(err)), 4),
            "p90": round(float(np.quantile(err, 0.9)), 4),
            "p99": round(float(np.quantile(err, 0.99)), 4),
            "max": round(float(err.max()), 3),
            "frac_gt_1cell": round(float(np.mean(err > cell)), 5),
            "frac_gt_4cell": round(float(np.mean(err > 4 * cell)), 5)}


def build_texture(map_name: str, stride: int, device):
    """The [R | e w | gx gy] texture of a packaged map, marched on ``device``."""
    base = SimConfig(num_agents=1, num_beams=1080, dtype="float32", scan_mode="fast",
                     rt_pose_stride=stride, rt_occlusion="edge", rt_grad=True)
    tmap32 = load_map(assets.named_map_yaml(map_name), ".png", dtype=torch.float32,
                      device=device)
    with torch.no_grad():
        return scan_fast.build_range_texture(tmap32, base)


def study(poses, full, device, map_name: str = "track_wide", stride: int = 2,
          log: bool = True):
    """The oracle and the rows of the modes for ``poses`` (n, 3) with the
    texture ``full`` (on ``device``) -> (rows, the oracle's scans (n, B))."""
    y = assets.named_map_yaml(map_name)
    base = SimConfig(num_agents=1, num_beams=1080, dtype="float32", scan_mode="fast",
                     rt_pose_stride=stride)
    cfg64 = dataclasses.replace(base, dtype="float64", rt_occlusion="off", rt_grad=False)
    tmap32 = load_map(y, ".png", dtype=torch.float32, device=device)
    tmap64 = load_map(y, ".png", dtype=torch.float64, device=device)
    tab32 = scan_ops.build_tables(base, 0.31, 0.58, dtype=torch.float32, device=device)
    tab64 = scan_ops.build_tables(cfg64, 0.31, 0.58, dtype=torch.float64, device=device)
    with torch.no_grad():
        exact = scan_ops.trace(torch.as_tensor(poses, device=device), tab64, tmap64,
                               cfg64).cpu().numpy()
    cell = float(full.cell)
    t_bins = base.rt_theta_bins
    results = []
    poses32 = torch.as_tensor(poses, dtype=torch.float32, device=device)[:, None]
    for occ, grad in COMBOS:
        for spatial in ("nearest1", "bilinear"):
            for interp in (("linear",) if occ != "off" else ("linear", "spectral")):
                c = dataclasses.replace(base, rt_occlusion=occ, rt_grad=grad,
                                        rt_spatial=spatial, scan_interp=interp)
                rtex = _columns(full, t_bins, c.rt_eff_occlusion, grad)
                with torch.no_grad():
                    fast = scan_fast.trace_fast_mxu(poses32, tab32, tmap32, rtex, c)
                row = error_row(exact, fast[:, 0].cpu().numpy(), cell, occ=occ,
                                grad=grad, spatial=spatial, interp=interp)
                results.append(row)
                if log:
                    print(json.dumps(row), flush=True)
    return results, exact


def main(argv=None):
    """-> (the JSON rows, the poses (n, 3), the float64 oracle's scans)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    torch.set_float32_matmul_precision("highest")
    tmap64 = load_map(assets.named_map_yaml(args.map), ".png", dtype=torch.float64,
                      device=device)
    poses = sample_poses(tmap64, args.poses, np.random.default_rng(args.seed))
    full = build_texture(args.map, args.rt_stride, device)
    rows, exact = study(poses, full, device, args.map, args.rt_stride)
    return rows, poses, exact


if __name__ == "__main__":
    main()
