"""Pure-pursuit waypoint follower over batched tensors.

PyTorch counterpart of ``red_gym_tpu/agents/pure_pursuit.py``, the
functional form of the reference example planner (reference:
examples/waypoint_follow.py:15-217).  The JAX package writes each function
for one car and vmaps it; here the poses carry any leading shape ``S`` and
every function broadcasts over the segments, ``S + (N-1,)``.  The waypoint
table may carry leading axes of its own that broadcast against ``S`` (a
table per env, ``(E, 1, N, 3)`` against ``(E, A)`` poses: see
``agents.ppo.pure_pursuit_opponents_multi``).  The reference's sequential
early-exit searches become reductions over all segments that pick the same
segment: the first one on ties, as ``jnp.argmin`` does.

Reference quirks preserved:
  * the circle-intersection segment end gets +1e-6 added element-wise
    (waypoint_follow.py:66);
  * the chosen lookahead point snaps to waypoint ``i2`` (the segment start),
    not the interpolated intersection (waypoint_follow.py:195-196);
  * the target speed is read at the *nearest* segment index ``i``
    (waypoint_follow.py:197);
  * no target found -> (speed 4.0, steer 0.0) (waypoint_follow.py:211-212).

Memory: with one table, each ``S + (N-1,)`` temporary of 16384 envs x 2
agents x 599 segments is 78 MB in float32; ``first_intersection`` holds at
most about eight of them at once, and frees each as soon as it is used.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from red_gym_tpu_torch.config import resolve_device


class PurePursuitParams(NamedTuple):
    waypoints: torch.Tensor      # (..., N, 3) columns [x, y, speed]
    tlad: torch.Tensor           # lookahead distance
    vgain: torch.Tensor          # speed gain
    wheelbase: torch.Tensor
    max_reacquire: torch.Tensor  # 20.0 in the reference


def load_waypoints_csv(path: str, delim: str = ";", skiprows: int = 3,
                       xind: int = 1, yind: int = 2, vind: int = 5,
                       dtype=torch.float64, device="cuda") -> torch.Tensor:
    """CSV loader matching the reference conf schema
    (examples/config_example_map.yaml wpt_* fields) -> (N, 3) [x, y, speed]
    on ``device`` (the card unless the caller passes "cpu")."""
    raw = np.loadtxt(path, delimiter=delim, skiprows=skiprows)
    return torch.as_tensor(raw[:, [xind, yind, vind]], dtype=dtype,
                           device=resolve_device(device))


def make_params(waypoints: torch.Tensor, tlad=0.82461887897713965, vgain=1.375,
                wheelbase=0.17145 + 0.15875, max_reacquire=20.0) -> PurePursuitParams:
    """Params with 0-d scalars in the waypoints' dtype, on their device."""
    t = lambda v: torch.as_tensor(v, dtype=waypoints.dtype,  # noqa: E731
                                  device=waypoints.device)
    return PurePursuitParams(waypoints=waypoints, tlad=t(tlad), vgain=t(vgain),
                             wheelbase=t(wheelbase), max_reacquire=t(max_reacquire))


def stack_params(ppps) -> PurePursuitParams:
    """Stack per-map PurePursuitParams along a leading map axis (waypoint
    tables must share a length: the packaged generator emits a fixed 600).
    Select env e's map with ``p[map_idx[e]]`` of every field (see
    agents.ppo.pure_pursuit_opponents_multi)."""
    n = {int(p.waypoints.shape[0]) for p in ppps}
    if len(n) != 1:
        raise ValueError(f"waypoint tables differ in length: {sorted(n)}; "
                         "resample them to a common count first")
    return PurePursuitParams(*[torch.stack([getattr(p, f) for p in ppps])
                               for f in PurePursuitParams._fields])


def _segments(traj):
    """Segment starts and direction components of traj (..., N, 2), each
    (..., N-1)."""
    sx, sy = traj[..., :-1, 0], traj[..., :-1, 1]
    return sx, sy, traj[..., 1:, 0] - sx, traj[..., 1:, 1] - sy


def _take(a, i):
    """a (..., n) broadcast against the index i (S) -> a[..., i] of shape S."""
    shape = torch.broadcast_shapes(a.shape[:-1], i.shape)
    return a.expand(shape + a.shape[-1:]).gather(-1, i.expand(shape)[..., None])[..., 0]


def nearest_point(px, py, traj):
    """Nearest point on the piecewise-linear trajectory (reference
    waypoint_follow.py:15-47).  px, py (S); traj (..., N, 2) broadcasting
    against S.  -> (proj (S + (2,)), dist (S), t (S), i (S) int64)."""
    sx, sy, dx, dy = _segments(traj)
    l2 = dx ** 2 + dy ** 2
    ex, ey = px[..., None] - sx, py[..., None] - sy
    t = torch.clamp((ex * dx + ey * dy) / l2, 0.0, 1.0)
    projx, projy = sx + t * dx, sy + t * dy
    del ex, ey
    dists = torch.sqrt((px[..., None] - projx) ** 2 + (py[..., None] - projy) ** 2)
    i = torch.argmin(dists, dim=-1)
    proj = torch.stack([_take(projx, i), _take(projy, i)], dim=-1)
    return proj, _take(dists, i), _take(t, i), i


def first_intersection(px, py, radius, traj, t0):
    """First circle/trajectory intersection walking forward from parameter
    t0 with wrap-around (reference waypoint_follow.py:49-131, wrap=True).

    px, py, t0 (S); radius broadcasting against S; traj (..., N, 2).
    Returns (found (S) bool, i2 (S) int64), where i2 indexes the segment
    start (N-1 for the wrap segment, mirroring the reference's -1).  The
    forward pass wins, then the wrap segment -1, then the wrapped segments
    0..start_i-1."""
    n = traj.shape[-2]
    start_i = torch.floor(t0).to(torch.int64)
    start_t = torch.remainder(t0, 1.0)
    r2 = (radius * radius)[..., None]
    p2 = (px * px + py * py)[..., None]
    pxe, pye = px[..., None], py[..., None]

    sx, sy = traj[..., :-1, 0], traj[..., :-1, 1]
    vx, vy = (traj[..., 1:, 0] + 1e-6) - sx, (traj[..., 1:, 1] + 1e-6) - sy
    a = vx * vx + vy * vy
    b = 2.0 * (vx * (sx - pxe) + vy * (sy - pye))
    c = (sx * sx + sy * sy) + p2 - 2.0 * (sx * pxe + sy * pye) - r2
    disc = b * b - 4 * a * c
    del c
    ok = disc >= 0
    sq = torch.sqrt(torch.where(ok, disc, torch.zeros_like(disc)))
    del disc
    t1 = (-b - sq) / (2 * a)
    t2 = (-b + sq) / (2 * a)
    del b, sq
    in01_1 = ok & (t1 >= 0.0) & (t1 <= 1.0)
    in01_2 = ok & (t2 >= 0.0) & (t2 <= 1.0)
    del ok

    seg = torch.arange(n - 1, device=traj.device)
    si, st = start_i[..., None], start_t[..., None]
    is_start_seg = seg == si
    acc1 = in01_1 & (~is_start_seg | (t1 >= st))
    acc2 = in01_2 & (~is_start_seg | (t2 >= st))
    del t1, t2, is_start_seg
    big = n + 10
    bigt = torch.tensor(big, device=traj.device)
    i_fwd = torch.where((acc1 | acc2) & (seg >= si), seg, bigt).amin(-1)
    del acc1, acc2
    found_fwd = i_fwd < big

    # wrap pass: segments -1, 0, .., start_i-1 (no start_t filter).
    # segment -1 = (traj[-1], traj[0]); its quadratic:
    swx, swy = traj[..., -1, 0], traj[..., -1, 1]
    vwx, vwy = (traj[..., 0, 0] + 1e-6) - swx, (traj[..., 0, 1] + 1e-6) - swy
    aw = vwx * vwx + vwy * vwy
    bw = 2.0 * (vwx * (swx - px) + vwy * (swy - py))
    cw = ((swx * swx + swy * swy) + (px * px + py * py)
          - 2.0 * (swx * px + swy * py) - radius * radius)
    dw = bw * bw - 4 * aw * cw
    okw = dw >= 0
    sqw = torch.sqrt(torch.where(okw, dw, torch.zeros_like(dw)))
    t1w = (-bw - sqw) / (2 * aw)
    t2w = (-bw + sqw) / (2 * aw)
    accw = okw & (((t1w >= 0.0) & (t1w <= 1.0)) | ((t2w >= 0.0) & (t2w <= 1.0)))

    i_wrap_pos = torch.where((in01_1 | in01_2) & (seg < si), seg, bigt).amin(-1)
    found_wrap_pos = i_wrap_pos < big

    i2 = torch.where(found_fwd, i_fwd,
                     torch.where(accw, torch.full_like(i_fwd, n - 1),
                                 torch.where(found_wrap_pos, i_wrap_pos,
                                             torch.zeros_like(i_fwd))))
    return found_fwd | accw | found_wrap_pos, i2


def plan(pose_x, pose_y, pose_theta, pp: PurePursuitParams):
    """(speed, steer) actuation (reference waypoint_follow.py:133-217) for
    poses of any shape S; pp's fields broadcast against S."""
    traj = pp.waypoints[..., 0:2]
    _, nearest_dist, t, i = nearest_point(pose_x, pose_y, traj)
    found, i2 = first_intersection(pose_x, pose_y, pp.tlad, traj, i + t)

    speed_i = _take(pp.waypoints[..., 2], i)
    use_inter = nearest_dist < pp.tlad
    use_near = (~use_inter) & (nearest_dist < pp.max_reacquire)
    have_wp = (use_inter & found) | use_near
    j = torch.where(use_inter, i2, i)
    wx, wy = _take(traj[..., 0], j), _take(traj[..., 1], j)

    # get_actuation (waypoint_follow.py:133-144)
    way_y = (torch.sin(-pose_theta) * (wx - pose_x)
             + torch.cos(-pose_theta) * (wy - pose_y))
    radius_inv = 2.0 * way_y / (pp.tlad ** 2)
    steer = torch.where(torch.abs(way_y) < 1e-6, torch.zeros_like(way_y),
                        torch.arctan(pp.wheelbase * radius_inv))
    speed = pp.vgain * speed_i

    speed = torch.where(have_wp, speed, torch.full_like(speed, 4.0))
    steer = torch.where(have_wp, steer, torch.zeros_like(steer))
    return speed, steer


class FlippyPlanner:
    """Adversarial integrator probe (reference waypoint_follow.py:220-238):
    alternates full steer every `flip_every` steps at constant speed."""

    def __init__(self, speed=1.0, flip_every=1, steer=2.0):
        self.speed, self.flip_every, self.steer0 = speed, flip_every, steer

    def plan_step(self, step_idx):
        step_idx = torch.as_tensor(step_idx)
        sign = torch.where((step_idx // self.flip_every) % 2 == 0, -1.0, 1.0)
        return torch.as_tensor(self.speed), sign * self.steer0
