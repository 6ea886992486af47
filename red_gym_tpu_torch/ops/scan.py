"""Lidar tables and the exact sphere march on the map's distance transform.

PyTorch counterpart of ``red_gym_tpu/ops/scan.py`` (reference:
gym/f110_gym/envs/laser_models.py:56-186).  The march here builds the fast
scan's range texture; every ray runs the reference's arithmetic, so in
float64 the ranges match the JAX march.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from red_gym_tpu_torch.config import SimConfig
from red_gym_tpu_torch.maps.loader import TrackMap

# march(): rays still running are compacted out every this many iterations
# (one host sync each); iterations past a ray's end are no-ops for it
_MARCH_CHECK_EVERY = 8


class ScanTables(NamedTuple):
    """Static per-config lidar tables, precomputed on the host in float64
    (reference laser_models.py:378-381, base_classes.py:116-156)."""

    sines: torch.Tensor           # (theta_dis,)
    cosines: torch.Tensor         # (theta_dis,)
    scan_angles: torch.Tensor     # (num_beams,) beam angle in body frame
    beam_cosines: torch.Tensor    # (num_beams,)
    beam_sines: torch.Tensor      # (num_beams,)
    side_distances: torch.Tensor  # (num_beams,) lidar -> car-edge distance
    # the JAX package's wrap-extended pool of noise_mode="pool_rot"; unused
    # here: the port's megakernel indexes the pool modulo its row count
    noise_pool_ext: Optional[torch.Tensor] = None


def build_tables(cfg: SimConfig, width: float, length: float, dtype=None,
                 device="cpu") -> ScanTables:
    """Host-side float64 precompute, the same numpy math as the JAX package."""
    dtype = dtype or cfg.tdtype
    theta_arr = np.linspace(0.0, 2 * np.pi, num=cfg.theta_dis)
    incr = cfg.fov / (cfg.num_beams - 1)
    angles = -cfg.fov / 2.0 + np.arange(cfg.num_beams) * incr

    dist_sides = width / 2.0
    dist_fr = length / 2.0
    with np.errstate(divide="ignore"):
        to_side = np.where(
            angles > 0,
            np.where(angles < np.pi / 2, dist_sides / np.sin(angles),
                     dist_sides / np.cos(angles - np.pi / 2)),
            np.where(angles > -np.pi / 2, dist_sides / np.sin(-angles),
                     dist_sides / np.cos(-angles - np.pi / 2)))
        to_fr = np.where(
            angles > 0,
            np.where(angles < np.pi / 2, dist_fr / np.cos(angles),
                     dist_fr / np.sin(angles - np.pi / 2)),
            np.where(angles > -np.pi / 2, dist_fr / np.cos(-angles),
                     dist_fr / np.sin(-angles - np.pi / 2)))
    side_distances = np.minimum(to_side, to_fr)

    def t(v):
        return torch.as_tensor(v, dtype=dtype, device=device)

    return ScanTables(sines=t(np.sin(theta_arr)), cosines=t(np.cos(theta_arr)),
                      scan_angles=t(angles), beam_cosines=t(np.cos(angles)),
                      beam_sines=t(np.sin(angles)),
                      side_distances=t(side_distances))


def dt_lookup(x, y, tmap: TrackMap):
    """Distance to the nearest obstacle at world point(s) (x, y).

    Reference xy_2_rc semantics (laser_models.py:56-104), including the
    out-of-bounds quirk: a point outside the map reads dt[h-1, w-1]."""
    x_trans = x - tmap.orig_x
    y_trans = y - tmap.orig_y
    x_rot = x_trans * tmap.orig_c + y_trans * tmap.orig_s
    y_rot = -x_trans * tmap.orig_s + y_trans * tmap.orig_c

    res = tmap.resolution
    w_m = tmap.width.to(x_rot.dtype) * res
    h_m = tmap.height.to(y_rot.dtype) * res
    oob = (x_rot < 0) | (x_rot >= w_m) | (y_rot < 0) | (y_rot >= h_m)

    c = (x_rot / res).to(torch.int32)
    r = (y_rot / res).to(torch.int32)
    full_h, full_w = tmap.dt.shape
    r = torch.where(oob, tmap.height - 1, torch.clamp(r, 0, full_h - 1))
    c = torch.where(oob, tmap.width - 1, torch.clamp(c, 0, full_w - 1))
    return tmap.dt.reshape(-1)[(r * full_w + c).long()]


def _march_body(x, y, c, s, d, total, tmap, eps, max_range):
    act = (d > eps) & (total <= max_range)
    x = torch.where(act, x + d * c, x)
    y = torch.where(act, y + d * s, y)
    d_new = dt_lookup(x, y, tmap)
    d = torch.where(act, d_new, d)
    total = torch.where(act, total + d_new, total)
    return x, y, d, total


def march(x, y, c, s, tmap: TrackMap, cfg: SimConfig):
    """Sphere march from points (x, y) along directions (c, s), all of one
    shape (reference trace_ray, laser_models.py:107-146): step the full safe
    distance until within eps of an obstacle or beyond max_range, then
    clamp to max_range.

    With ``cfg.march_iters == 0`` the rays run until all have ended.  The
    rays still running are compacted every few iterations, so late
    iterations touch only the few long rays; extra iterations are no-ops
    for a ray that has ended, so the result is the same as marching all
    rays in lockstep."""
    shape = x.shape
    x, y = x.reshape(-1), y.reshape(-1)
    c = torch.broadcast_to(c, shape).reshape(-1)
    s = torch.broadcast_to(s, shape).reshape(-1)
    d = dt_lookup(x, y, tmap)
    total = d.clone()
    eps, max_range = cfg.eps, cfg.max_range

    if cfg.march_iters > 0:
        for _ in range(cfg.march_iters):
            x, y, d, total = _march_body(x, y, c, s, d, total, tmap, eps,
                                         max_range)
        return torch.clamp(total, max=max_range).reshape(shape)

    out = total.clone()
    live = torch.arange(x.numel(), device=x.device)
    while True:
        act = (d > eps) & (total <= max_range)
        keep = torch.nonzero(act).squeeze(1)
        out[live] = total
        if keep.numel() == 0:
            break
        live = live[keep]
        x, y, c, s, d, total = (v[keep] for v in (x, y, c, s, d, total))
        for _ in range(_MARCH_CHECK_EVERY):
            x, y, d, total = _march_body(x, y, c, s, d, total, tmap, eps,
                                         max_range)
    return torch.clamp(out, max=max_range).reshape(shape)


def trace_angles(origins, angles, tmap: TrackMap, cfg: SimConfig):
    """Scan at exact world angles: origins (..., 2), angles (T,) ->
    (..., T).  Builds the fast scan's range texture."""
    shape = origins.shape[:-1] + angles.shape
    x = torch.broadcast_to(origins[..., 0:1], shape)
    y = torch.broadcast_to(origins[..., 1:2], shape)
    return march(x, y, torch.cos(angles), torch.sin(angles), tmap, cfg)
