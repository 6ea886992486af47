"""Scan post-processing against other agents: iTTC and opponent ray casting.

PyTorch counterpart of ``red_gym_tpu/ops/agent_scan.py`` (reference:
laser_models.py:188-346).  The reference's per-opponent index window becomes
a beam mask and its per-edge tests one slab test per beam, so the shapes
stay static and every agent of every env is cast in one pass per opponent.
"""

from __future__ import annotations

import math

import torch

from red_gym_tpu_torch.ops.scan import ScanTables


def check_ttc(scan, vel, tables: ScanTables, ttc_thresh):
    """Instantaneous time-to-collision wall check (reference check_ttc_jit,
    laser_models.py:188-217): collision iff some beam's
    (range - side_distance) / (v * cos(angle)) lies in [0, thresh), tested
    multiplied out, split on the sign of the denominator.
    scan (..., B), vel (...) -> bool (...)."""
    proj_vel = vel[..., None] * tables.beam_cosines
    num = scan - tables.side_distances
    hit = torch.where(proj_vel > 0,
                      (num >= 0) & (num < ttc_thresh * proj_vel),
                      (proj_vel < 0) & (num <= 0) & (num > ttc_thresh * proj_vel))
    return torch.any(hit, dim=-1) & (vel != 0.0)


def _wrap_pi(a):
    """Wrap to (-pi, pi] with one correction each way (laser_models.py:304-307)."""
    a = torch.where(a > math.pi, a - 2 * math.pi, a)
    return torch.where(a < -math.pi, a + 2 * math.pi, a)


def blocked_view_window(pose, vertices, tables: ScanTables):
    """(lo, hi) int32 beam window blocked by an opponent body (reference
    get_blocked_view_indices, laser_models.py:283-315): the four
    pose->corner bearings snapped to the beam grid.
    pose (..., 3), vertices (..., 4, 2) -> ((...,), (...,))."""
    vecs = vertices - pose[..., None, 0:2]
    unit_angle = torch.atan2(vecs[..., 1], vecs[..., 0])
    ego_angle = torch.atan2(torch.sin(pose[..., 2]), torch.cos(pose[..., 2]))
    bearings = -_wrap_pi(ego_angle[..., None] - unit_angle)
    n_b = tables.scan_angles.shape[0]
    a0 = tables.scan_angles[0]
    incr = (tables.scan_angles[-1] - a0) / (n_b - 1)
    inds = torch.clamp(torch.round((bearings - a0) / incr), 0, n_b - 1)
    inds = inds.to(torch.int32)
    return inds.amin(dim=-1), inds.amax(dim=-1)


def beam_dirs(pose_theta, tables: ScanTables):
    """World-frame unit direction of every beam: (...,) -> (..., B, 2), by
    angle addition against the static per-beam sin/cos tables."""
    ct, st = torch.cos(pose_theta)[..., None], torch.sin(pose_theta)[..., None]
    dx = ct * tables.beam_cosines - st * tables.beam_sines
    dy = st * tables.beam_cosines + ct * tables.beam_sines
    return torch.stack([dx, dy], dim=-1)


def _slab(o_u, o_w, d_u, d_w, hu, hw):
    """Ray-vs-box slab test in the opponent's body frame: origin (o_u, o_w),
    direction (d_u, d_w), half extents (hu, hw) -> nonnegative ray
    parameter of the hit, or +inf."""
    inf = torch.full((), math.inf, dtype=d_u.dtype, device=d_u.device)

    def axis(o, d, h):
        inv = 1.0 / d
        t1 = (-h - o) * inv
        t2 = (h - o) * inv
        near = torch.minimum(t1, t2)
        far = torch.maximum(t1, t2)
        # beam parallel to the slab: inside -> (-inf, inf), outside -> miss
        par = d == 0.0
        inside = torch.abs(o) <= h
        near = torch.where(par, torch.where(inside, -inf, inf), near)
        far = torch.where(par, torch.where(inside, inf, -inf), far)
        return near, far

    near_u, far_u = axis(o_u, d_u, hu)
    near_w, far_w = axis(o_w, d_w, hw)
    tmin = torch.maximum(near_u, near_w)
    tmax = torch.minimum(far_u, far_w)
    hit = (tmax >= tmin) & (tmax >= 0.0)
    t = torch.where(tmin >= 0.0, tmin, tmax)   # from inside: exit distance
    return torch.where(hit, t, inf)


def ray_cast_opponent(pose, scan, vertices, tables: ScanTables, dirs=None):
    """Shorten scan beams blocked by one opponent rectangle (reference
    ray_cast, laser_models.py:319-346).  pose (..., 3), scan (..., B),
    vertices (..., 4, 2); ``dirs`` = beam_dirs(pose theta) may be shared."""
    lo, hi = blocked_view_window(pose, vertices, tables)
    beam_idx = torch.arange(tables.scan_angles.shape[0], device=scan.device)
    mask = (beam_idx >= lo[..., None]) & (beam_idx <= hi[..., None])
    if dirs is None:
        dirs = beam_dirs(pose[..., 2], tables)

    # opponent box frame from its corners [rear-left, rear-right,
    # front-right, front-left]
    center = torch.mean(vertices, dim=-2)
    e_l = vertices[..., 3, :] - vertices[..., 0, :]
    e_w = vertices[..., 0, :] - vertices[..., 1, :]
    len_l = torch.linalg.norm(e_l, dim=-1, keepdim=True)
    len_w = torch.linalg.norm(e_w, dim=-1, keepdim=True)
    u = e_l / len_l
    w = e_w / len_w
    o = pose[..., 0:2] - center
    o_u = torch.sum(o * u, dim=-1, keepdim=True)
    o_w = torch.sum(o * w, dim=-1, keepdim=True)
    d_u = dirs[..., 0] * u[..., 0:1] + dirs[..., 1] * u[..., 1:2]
    d_w = dirs[..., 0] * w[..., 0:1] + dirs[..., 1] * w[..., 1:2]
    t = _slab(o_u, o_w, d_u, d_w, 0.5 * len_l, 0.5 * len_w)
    return torch.where(mask, torch.minimum(scan, t), scan)


def ray_cast_all_opponents(poses, scans, all_vertices, tables: ScanTables):
    """Opponent ray casting of every agent against every other agent:
    poses (..., A, 3), scans (..., A, B), all_vertices (..., A, 4, 2).
    Opponents are paired by rolling the agent axis; min-accumulation over
    opponents commutes, so this equals the reference's sequential loop
    (base_classes.py:204-225)."""
    num_agents = poses.shape[-2]
    dirs = beam_dirs(poses[..., 2], tables)
    out = scans
    for k in range(1, num_agents):
        verts_k = torch.roll(all_vertices, -k, dims=-3)   # opponent (i+k) % A
        out = ray_cast_opponent(poses, out, verts_k, tables, dirs)
    return out
