"""The sphere march of the exact lidar scan, as one CUDA kernel.

Replaces no TPU kernel: the JAX package marches with one ``lax.while_loop``
(or a ``fori_loop`` budget) that XLA compiles into one loop on the device
(``red_gym_tpu/ops/scan.py::march``, :153-186).  Its eager PyTorch form
launches about 15 tensor ops an iteration over every running ray; at step
time the exact scan marches 16384 x 2 x 1080 = 35.4M rays, so here the loop
is a kernel (``red_gym_tpu_torch/csrc/march.cu``): one thread a ray marches
it to its end (reference trace_ray, laser_models.py:107-146):

    d = total = dt(x, y)
    while d > eps and total <= max_range:      # or march_iters times
        x, y = x + d c, y + d s
        d = dt(x, y); total += d
    return min(total, max_range)

where dt is :func:`dt_lookup`, the reference's cell lookup with its
out-of-map read of dt[h-1, w-1].  The kernel takes two forms on one device
function: ``rays`` (flat x, y, c, s: the range-texture build,
:func:`march`) and ``beams`` (a pose row per car and the theta tables: each
thread computes its beam's theta index as :func:`beam_theta_indices` does
and reads its cos/sin from the tables, so no (K, B) array but the output
is written: :func:`march_beams`).

Both forms march one map, or a stack of M maps padded to one shape
(``maps.loader.stack_maps``: dt (M, H, W), scalars (M,)) with an int32 map
index ``midx`` per ray or per pose row (the JAX package's ``midx``,
``red_gym_tpu/ops/scan.py:96-137``): a ray reads its map's origin,
resolution and true extents, its out-of-map cell dt[m, h_m-1, w_m-1], and
the distance transform at m * H * W.  The index must lie in [0, M); the
env checks it once, at reset (``env.reset``), not the kernel.

On CUDA tensors both wrappers launch the kernel or raise, never a fallback;
on CPU tensors they run the plain twins :func:`march_reference` and
:func:`march_beams_reference`.  ``march.launches`` and
``march_beams.launches`` count kernel launches.  The source is built with
``-fmad=false`` (``ops/_build.py``) and keeps the twin's operation order,
IEEE division and truncating casts, so the kernel and its twin agree bit
for bit on the card (``torch.equal``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from refsim.config import SimConfig
from refsim.maps.loader import TrackMap

# the twin's march compacts the rays still running every this many
# iterations (one host sync each); iterations past a ray's end are no-ops
# for it
_MARCH_CHECK_EVERY = 8
_MAP_FIELDS = ("orig_x", "orig_y", "orig_c", "orig_s", "resolution")


def map_scalars(tmap: TrackMap, midx=None):
    """(orig_x, orig_y, orig_c, orig_s, resolution, height, width) of one
    map, or with ``midx`` those of each element's map of a stack (JAX
    scan.map_scalars)."""
    fields = (*_MAP_FIELDS, "height", "width")
    if midx is None:
        return tuple(getattr(tmap, f) for f in fields)
    return tuple(getattr(tmap, f)[midx] for f in fields)


def dt_lookup(x, y, tmap: TrackMap, midx=None):
    """Distance to the nearest obstacle at world point(s) (x, y), on one map
    or, with ``midx`` (int of x's shape), on each point's map of a stack.

    Reference xy_2_rc semantics (laser_models.py:56-104), including the
    out-of-bounds quirk: a point outside the map reads dt[h-1, w-1] of its
    map's true extents."""
    ox, oy, oc, osn, res, height, width = map_scalars(tmap, midx)
    x_trans = x - ox
    y_trans = y - oy
    x_rot = x_trans * oc + y_trans * osn
    y_rot = -x_trans * osn + y_trans * oc

    w_m = width.to(x_rot.dtype) * res
    h_m = height.to(y_rot.dtype) * res
    oob = (x_rot < 0) | (x_rot >= w_m) | (y_rot < 0) | (y_rot >= h_m)

    c = (x_rot / res).to(torch.int32)
    r = (y_rot / res).to(torch.int32)
    full_h, full_w = tmap.dt.shape[-2:]
    r = torch.where(oob, height - 1, torch.clamp(r, 0, full_h - 1))
    c = torch.where(oob, width - 1, torch.clamp(c, 0, full_w - 1))
    idx = r.long() * full_w + c
    if midx is not None:
        idx = idx + midx.long() * (full_h * full_w)
    return tmap.dt.reshape(-1)[idx]


def beam_theta_indices(pose_theta, cfg: SimConfig):
    """Theta-table index of every beam of a pose: (...,) -> int32 (...,
    num_beams), the wrap-as-you-go accumulation of the reference
    (laser_models.py:166-184) in the JAX package's vectorized form.

    The arithmetic is the one XLA compiles JAX's expression to in the env
    step: ``theta_dis * (theta - fov/2) / 2pi`` as one product with the
    folded constant ``theta_dis / 2pi``, a floored remainder (jnp.mod's
    sign, as torch.remainder's), then the beam offset ``t0 + inc * b`` with
    one rounding, as the fused multiply-add of XLA's CPU loop rounds it (in
    float32 the sum is taken in float64, where the product is exact, and
    rounded once to float32), a second remainder and a truncating cast.
    ``march_beams``'s kernel computes the same operations on the card."""
    theta_dis, b_n = cfg.theta_dis, cfg.num_beams
    inc = theta_dis * (cfg.fov / (b_n - 1)) / (2.0 * math.pi)
    t0 = torch.remainder((pose_theta - cfg.fov / 2.0)
                         * (theta_dis / (2.0 * math.pi)), float(theta_dis))
    beams = torch.arange(b_n, dtype=torch.float64, device=pose_theta.device)
    if pose_theta.dtype == torch.float32:
        ti = (t0.double()[..., None] + float(np.float32(inc)) * beams).float()
    else:
        ti = t0[..., None] + inc * beams
    return torch.remainder(ti, float(theta_dis)).to(torch.int32)


def _march_body(x, y, c, s, d, total, tmap, eps, max_range, midx=None):
    """One march iteration of every ray; a ray that has ended keeps its
    values."""
    act = (d > eps) & (total <= max_range)
    x = torch.where(act, x + d * c, x)
    y = torch.where(act, y + d * s, y)
    d_new = dt_lookup(x, y, tmap, midx)
    d = torch.where(act, d_new, d)
    total = torch.where(act, total + d_new, total)
    return x, y, d, total


def march_reference(x, y, c, s, tmap: TrackMap, cfg: SimConfig, midx=None):
    """Plain twin of the march kernel: rays from points (x, y) along
    directions (c, s), all of one shape, marched in lockstep, on one map or,
    with ``midx`` (int, broadcast to x's shape), on each ray's map of a
    stack.

    With ``cfg.march_iters == 0`` the rays run until all have ended; the
    rays still running (and their map indices) are compacted every few
    iterations, so late iterations touch only the few long rays.  Extra
    iterations are no-ops for a ray that has ended, so the result is that
    of marching every ray alone."""
    shape = x.shape
    x, y = x.reshape(-1), y.reshape(-1)
    c = torch.broadcast_to(c, shape).reshape(-1)
    s = torch.broadcast_to(s, shape).reshape(-1)
    if midx is not None:
        midx = torch.broadcast_to(midx, shape).reshape(-1)
    d = dt_lookup(x, y, tmap, midx)
    total = d.clone()
    eps, max_range = cfg.eps, cfg.max_range

    if cfg.march_iters > 0:
        for _ in range(cfg.march_iters):
            x, y, d, total = _march_body(x, y, c, s, d, total, tmap, eps,
                                         max_range, midx)
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
        if midx is not None:
            midx = midx[keep]
        for _ in range(_MARCH_CHECK_EVERY):
            x, y, d, total = _march_body(x, y, c, s, d, total, tmap, eps,
                                         max_range, midx)
    return torch.clamp(out, max=max_range).reshape(shape)


def march_beams_reference(poses, cosines, sines, tmap: TrackMap,
                          cfg: SimConfig, midx=None):
    """Plain twin of the march kernel's beams form: poses (..., 3) ->
    ranges (..., num_beams), each beam along the theta-table direction of
    :func:`beam_theta_indices` (reference get_scan, laser_models.py:149-186),
    with ``midx`` (broadcast to poses' (...)) on each pose's map of a
    stack."""
    idx = beam_theta_indices(poses[..., 2], cfg)
    shape = idx.shape
    x = torch.broadcast_to(poses[..., 0:1], shape)
    y = torch.broadcast_to(poses[..., 1:2], shape)
    if midx is not None:
        midx = torch.broadcast_to(midx, shape[:-1])[..., None].expand(shape)
    return march_reference(x, y, cosines[idx], sines[idx], tmap, cfg, midx)


def march(x, y, c, s, tmap: TrackMap, cfg: SimConfig, midx=None):
    """The march's rays form, its twin :func:`march_reference`, on every
    device."""
    return march_reference(x, y, c, s, tmap, cfg, midx)


def march_beams(poses, cosines, sines, tmap: TrackMap, cfg: SimConfig,
                midx=None):
    """The march's beams form, its twin :func:`march_beams_reference`, on
    every device."""
    return march_beams_reference(poses, cosines, sines, tmap, cfg, midx)
