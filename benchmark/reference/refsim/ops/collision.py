"""Vehicle body corners and pairwise collision checks.

PyTorch counterpart of ``red_gym_tpu/ops/collision.py``.  The reference's
GJK test (collision_models.py:34-212) becomes the separating-axis test (SAT):
for two convex quads given by their vertices (``collision``,
``collision_multiple``), and for two rectangles in closed form straight from
poses (``pairwise_hits_from_poses``, the env step's).  Touching bodies count
as not colliding.
"""

from __future__ import annotations

import torch


def get_vertices(pose, length, width):
    """Body corners [rear-left, rear-right, front-right, front-left]
    (reference collision_models.py:218-260); pose (..., 3) -> (..., 4, 2)."""
    x, y, th = pose[..., 0], pose[..., 1], pose[..., 2]
    c, s = torch.cos(th), torch.sin(th)
    hl = torch.as_tensor(length, dtype=pose.dtype, device=pose.device) / 2.0
    hw = torch.as_tensor(width, dtype=pose.dtype, device=pose.device) / 2.0
    hl, hw = torch.broadcast_tensors(hl, hw)
    lx = torch.stack([-hl, -hl, hl, hl], dim=-1)   # (..., 4)
    ly = torch.stack([hw, -hw, -hw, hw], dim=-1)
    wx = x[..., None] + c[..., None] * lx - s[..., None] * ly
    wy = y[..., None] + s[..., None] * lx + c[..., None] * ly
    return torch.stack([wx, wy], dim=-1)


def _obb_overlap(pose1, pose2, hl1, hw1, hl2, hw2):
    """Rectangle-vs-rectangle SAT straight from poses: 4 axes, closed-form
    projections.  pose* (..., 3); h* half extents, broadcastable."""
    dx = pose2[..., 0] - pose1[..., 0]
    dy = pose2[..., 1] - pose1[..., 1]
    c1, s1 = torch.cos(pose1[..., 2]), torch.sin(pose1[..., 2])
    c2, s2 = torch.cos(pose2[..., 2]), torch.sin(pose2[..., 2])
    a_uu = torch.abs(c1 * c2 + s1 * s2)    # |u1.u2| = |w1.w2|
    a_uw = torch.abs(s1 * c2 - c1 * s2)    # |u1.w2| = |w1.u2|
    sep = ((torch.abs(dx * c1 + dy * s1) >= hl1 + hl2 * a_uu + hw2 * a_uw)
           | (torch.abs(-dx * s1 + dy * c1) >= hw1 + hl2 * a_uw + hw2 * a_uu)
           | (torch.abs(dx * c2 + dy * s2) >= hl2 + hl1 * a_uu + hw1 * a_uw)
           | (torch.abs(-dx * s2 + dy * c2) >= hw2 + hl1 * a_uw + hw1 * a_uu))
    return ~sep


def pairwise_hits_from_poses(poses, length, width):
    """Per-agent body-collision flags: poses (..., A, 3) -> bool (..., A).

    Agents are paired by rolling the agent axis: pass k tests i against
    i+k, and its result also flags i+k (the even-A middle pass already sees
    each pair from both sides).  length/width are scalars, (A,) or any
    shape that broadcasts against (..., A): (E, 1) gives each env its own
    car (a parameter-search population)."""
    a_n = poses.shape[-2]
    shape = poses.shape[:-1]
    hl = torch.broadcast_to(
        torch.as_tensor(length, dtype=poses.dtype, device=poses.device) / 2.0, shape)
    hw = torch.broadcast_to(
        torch.as_tensor(width, dtype=poses.dtype, device=poses.device) / 2.0, shape)
    hits = torch.zeros(shape, dtype=torch.bool, device=poses.device)
    for k in range(1, a_n // 2 + 1):
        other = torch.roll(poses, -k, dims=-2)
        o = _obb_overlap(poses, other, hl, hw, torch.roll(hl, -k, dims=-1),
                         torch.roll(hw, -k, dims=-1))
        hits = hits | o
        if not (a_n % 2 == 0 and k == a_n // 2):
            hits = hits | torch.roll(o, k, dims=-1)
    return hits


def _dot(u, v):
    """u . v over the last axis of length 2: the second product fused into
    the sum (``addcmul``), the rounding of the JAX package's einsum on the
    CPU, so that bodies on the verge of touching get the same answer."""
    return torch.addcmul(u[..., 0] * v[..., 0], u[..., 1], v[..., 1])


def _project_interval(verts, axis):
    """Min/max of vertices (..., 4, 2) projected on axis (..., 2)."""
    proj = _dot(verts, axis[..., None, :])
    return proj.amin(dim=-1), proj.amax(dim=-1)


def collision(verts1, verts2):
    """SAT overlap test for two convex quads (..., 4, 2) -> bool (...).

    The reference's GJK boolean (collision_models.py:113-182): True iff the
    interiors intersect; touching contact counts as no collision.  The
    candidate separating axes are the edge normals of both bodies."""
    def edge_normals(v):
        e = torch.roll(v, -1, dims=-2) - v                      # (..., 4, 2)
        return torch.stack([-e[..., 1], e[..., 0]], dim=-1)     # perpendicular

    verts1, verts2 = torch.broadcast_tensors(verts1, verts2)
    axes = torch.cat([edge_normals(verts1), edge_normals(verts2)], dim=-2)
    p1 = _dot(verts1[..., None, :, :], axes[..., :, None, :])  # (..., 8, 4)
    p2 = _dot(verts2[..., None, :, :], axes[..., :, None, :])
    separated = ((p1.amax(-1) <= p2.amin(-1))
                 | (p2.amax(-1) <= p1.amin(-1)))                # per axis
    return ~torch.any(separated, dim=-1)


def collision_multiple(vertices):
    """All-pairs collision over bodies (..., N, 4, 2) -> (collisions (..., N),
    collision_idx (..., N)), both in the vertices' dtype, with the
    reference's conventions (collision_models.py:184-212): the index is the
    largest-index colliding partner, or -1."""
    n = vertices.shape[-3]
    vi = vertices[..., :, None, :, :]   # (..., N, 1, 4, 2)
    vj = vertices[..., None, :, :, :]   # (..., 1, N, 4, 2)
    hits = collision(vi, vj)            # (..., N, N)
    hits = hits & ~torch.eye(n, dtype=torch.bool, device=vertices.device)
    any_hit = torch.any(hits, dim=-1)
    idx = torch.arange(n, device=vertices.device)
    partner = torch.amax(torch.where(hits, idx, -1), dim=-1)
    collisions = any_hit.to(vertices.dtype)
    collision_idx = torch.where(any_hit, partner, -1).to(vertices.dtype)
    return collisions, collision_idx
