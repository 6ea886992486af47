"""Scan post-processing against other agents: iTTC and opponent ray casting.

PyTorch counterpart of ``red_gym_tpu/ops/agent_scan.py`` (reference:
laser_models.py:188-346).  The reference's per-opponent index window becomes
a beam mask and its per-edge tests one slab test per beam, so the shapes
stay static and every agent of every env is cast in one pass per opponent.
"""

from __future__ import annotations

import math

import torch

from refsim.ops.scan import ScanTables


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


def get_range(pose, beam_theta, va, vb):
    """Distance from ``pose`` along the world angle ``beam_theta`` to the
    segment va->vb, inf where the beam misses it (reference get_range,
    laser_models.py:250-280), with the collinear fallback: a beam along
    the segment's line reads the nearer endpoint.  All arguments
    broadcast; pose (..., >=2), va and vb (..., 2)."""
    o = pose[..., 0:2]
    v1 = o - va
    v2 = vb - va
    v3 = torch.stack([torch.cos(beam_theta + math.pi / 2.0),
                      torch.sin(beam_theta + math.pi / 2.0)], dim=-1)
    denom = torch.sum(v2 * v3, dim=-1)
    d1 = (v2[..., 0] * v1[..., 1] - v2[..., 1] * v1[..., 0]) / denom
    d2 = torch.sum(v1 * v3, dim=-1) / denom
    valid = (torch.abs(denom) > 0.0) & (d1 >= 0.0) & (d2 >= 0.0) & (d2 <= 1.0)

    # collinear fallback (only reachable when denom == 0)
    ba = vb - va
    ca = va - o
    cross = ba[..., 0] * ca[..., 1] - ba[..., 1] * ca[..., 0]
    collinear = (torch.abs(denom) <= 0.0) & (torch.abs(cross) < 1e-8)
    d_col = torch.minimum(torch.linalg.norm(va - o, dim=-1),
                          torch.linalg.norm(vb - o, dim=-1))
    inf = torch.full_like(d1, math.inf)
    return torch.where(valid, d1, torch.where(collinear, d_col, inf))


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


def blocked_view_mask(pose, vertices, tables: ScanTables):
    """Beams [lo, hi] blocked by an opponent body, as a mask (the boolean
    form of ``blocked_view_window``).  pose (..., 3), vertices (..., 4, 2)
    -> bool (..., B)."""
    lo, hi = blocked_view_window(pose, vertices, tables)
    beam_idx = torch.arange(tables.scan_angles.shape[0], device=lo.device)
    return (beam_idx >= lo[..., None]) & (beam_idx <= hi[..., None])


def opponent_slab_scalars(poses, all_vertices, tables: ScanTables):
    """Per-agent packed scalars of the megakernel's in-kernel opponent ray
    cast (``scan_kernels.mega_edge_ttc(opp=...)``).

    poses (..., A, 3), all_vertices (..., A, 4, 2) -> (..., A, 10 * (A-1)):
    10 floats per opponent (i+k) % A, k = 1..A-1,
    [lo, hi, a_u, b_u, a_w, b_w, o_u, o_w, hu, hw], where the beam direction
    in the opponent's box frame is d_u[b] = a_u cos_b + b_u sin_b (the
    agent's heading folded into the box axes) and (lo, hi) is the
    blocked_view_window."""
    a_n = poses.shape[-2]
    ct, st = torch.cos(poses[..., 2]), torch.sin(poses[..., 2])   # (..., A)
    packs = []
    for k in range(1, a_n):
        verts = torch.roll(all_vertices, -k, dims=-3)
        lo, hi = blocked_view_window(poses, verts, tables)
        center = torch.mean(verts, dim=-2)                          # (..., A, 2)
        e_l = verts[..., 3, :] - verts[..., 0, :]
        e_w = verts[..., 0, :] - verts[..., 1, :]
        len_l = torch.linalg.norm(e_l, dim=-1)
        len_w = torch.linalg.norm(e_w, dim=-1)
        u = e_l / len_l[..., None]
        w = e_w / len_w[..., None]
        o = poses[..., 0:2] - center
        o_u = torch.sum(o * u, dim=-1)
        o_w = torch.sum(o * w, dim=-1)
        a_u = u[..., 0] * ct + u[..., 1] * st
        b_u = -u[..., 0] * st + u[..., 1] * ct
        a_w = w[..., 0] * ct + w[..., 1] * st
        b_w = -w[..., 0] * st + w[..., 1] * ct
        packs.append(torch.stack(
            [lo.to(poses.dtype), hi.to(poses.dtype), a_u, b_u, a_w, b_w,
             o_u, o_w, 0.5 * len_l, 0.5 * len_w], dim=-1))          # (..., A, 10)
    return torch.cat(packs, dim=-1)


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
