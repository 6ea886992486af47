"""The sphere march of the exact lidar scan, as one CUDA kernel.

Replaces no TPU kernel: the JAX package marches with one ``lax.while_loop``
(or a ``fori_loop`` budget) that XLA compiles into one loop on the device
(``red_gym_tpu/ops/scan.py::march``, :153-186).  Its eager PyTorch form
issues about 15 tensor ops an iteration over every running ray; at step
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

import ctypes
import functools
import math

import numpy as np
import torch

from red_gym_tpu_torch.config import SimConfig
from red_gym_tpu_torch.maps.loader import TrackMap
from red_gym_tpu_torch.ops import _build

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


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("march")
    p, i, i64, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_double
    # map operands: the map index (a null pointer for one map), dt,
    # orig_x, orig_y, orig_c, orig_s, resolution, height, width (device
    # pointers), full_h, full_w
    map_args = [p] * 9 + [i, i]
    lib.march_rays_launch.argtypes = ([p, p, p, p, i64] + map_args
                                      + [d, d, i, i, p, p])
    lib.march_rays_launch.restype = ctypes.c_int
    lib.march_beams_launch.argtypes = ([p, p, p, i64, i, i, d, d, d] + map_args
                                       + [d, d, i, i, p, p])
    lib.march_beams_launch.restype = ctypes.c_int
    return lib


def _map_args(tmap: TrackMap, dtype, device, midx, lead: tuple) -> tuple:
    """The kernel's map operands, checked, and the map index it reads
    (kept alive by the caller until the launch): every map tensor on
    ``device``, dt and the origin scalars of the march's dtype, height and
    width int32; one contiguous (H, W) map with 0-d scalars and ``midx``
    None, or a contiguous (M, H, W) stack with (M,) scalars and ``midx``
    of shape ``lead`` (one index a ray or a pose row)."""
    for name in ("dt", *_MAP_FIELDS, "height", "width"):
        t = getattr(tmap, name)
        if t.device != device:
            raise ValueError(f"tmap.{name} is on {t.device}, the rays on {device}")
    for name in ("dt", *_MAP_FIELDS):
        if getattr(tmap, name).dtype != dtype:
            raise ValueError(f"tmap.{name} is {getattr(tmap, name).dtype}, the "
                             f"rays {dtype}: load the map in the march's dtype")
    for name in ("height", "width"):
        if getattr(tmap, name).dtype != torch.int32:
            raise ValueError(f"tmap.{name} must be int32")
    if not tmap.dt.is_contiguous():
        raise ValueError("tmap.dt must be contiguous")
    stacked = tmap.dt.dim() == 3
    scalar_shape = tmap.dt.shape[:1] if stacked else ()
    if tmap.dt.dim() not in (2, 3) or any(
            getattr(tmap, f).shape != scalar_shape
            for f in (*_MAP_FIELDS, "height", "width")):
        raise ValueError("tmap must be one (H, W) map with 0-d scalars or a "
                         "stack (M, H, W) with (M,) scalars")
    if stacked != (midx is not None):
        raise ValueError("a stack of maps needs a map index (midx), and one "
                         "map takes none")
    ptr = None
    if midx is not None:
        if midx.dtype != torch.int32 or midx.device != device:
            raise ValueError(f"midx must be int32 on {device}, got {midx.dtype} "
                             f"on {midx.device}")
        if tuple(midx.shape) != lead:
            raise ValueError(f"midx must be {lead}, got {tuple(midx.shape)}")
        midx = midx.contiguous()
        ptr = midx.data_ptr()
    full_h, full_w = tmap.dt.shape[-2:]
    args = ([ptr, tmap.dt.data_ptr()] + [getattr(tmap, f).data_ptr() for f in _MAP_FIELDS]
            + [tmap.height.data_ptr(), tmap.width.data_ptr(), full_h, full_w])
    return args, midx


def _kernel_dtype(t: torch.Tensor) -> int:
    """1 for the kernel's double instance, 0 for its float one."""
    if t.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the march kernel takes float32 or float64, got {t.dtype}")
    return int(t.dtype == torch.float64)


def march(x, y, c, s, tmap: TrackMap, cfg: SimConfig, midx=None):
    """The march kernel's rays form on a CUDA device, its twin
    (:func:`march_reference`) on the CPU: rays from (x, y) along (c, s),
    which broadcast to x's shape -> ranges of that shape; with ``midx``
    (int32, broadcast to x's shape) on each ray's map of a stack."""
    if x.device.type == "cpu":
        return march_reference(x, y, c, s, tmap, cfg, midx)
    if x.device.type != "cuda":
        raise ValueError(f"march runs on cuda or cpu, not {x.device}")
    shape = x.shape
    rays = [torch.broadcast_to(v, shape).reshape(-1).contiguous()
            for v in (x, y, c, s)]
    if len({(v.device, v.dtype) for v in rays}) != 1:
        raise ValueError("x, y, c and s must share one device and dtype")
    double = _kernel_dtype(x)
    if midx is not None:
        midx = torch.broadcast_to(midx, shape).reshape(-1)
    args, midx = _map_args(tmap, x.dtype, x.device, midx, (x.numel(),))
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    err = _lib().march_rays_launch(
        *(v.data_ptr() for v in rays), out.numel(), *args, cfg.eps, cfg.max_range,
        cfg.march_iters, double, out.data_ptr(),
        torch._C._cuda_getCurrentRawStream(x.device.index))
    if err != 0:
        raise RuntimeError(f"march kernel launch failed: CUDA error {err}")
    march.launches += 1
    return out


march.launches = 0


def march_beams(poses, cosines, sines, tmap: TrackMap, cfg: SimConfig,
                midx=None):
    """The march kernel's beams form on a CUDA device, its twin
    (:func:`march_beams_reference`) on the CPU: poses (..., 3) -> ranges
    (..., num_beams) along the theta-table directions ``cosines``/``sines``
    (theta_dis,); with ``midx`` (int32, broadcast to poses' (...)) each
    pose on its map of a stack."""
    if poses.device.type == "cpu":
        return march_beams_reference(poses, cosines, sines, tmap, cfg, midx)
    if poses.device.type != "cuda":
        raise ValueError(f"march_beams runs on cuda or cpu, not {poses.device}")
    if poses.shape[-1] != 3:
        raise ValueError(f"poses must be (..., 3), got {tuple(poses.shape)}")
    double = _kernel_dtype(poses)
    for name, t in (("cosines", cosines), ("sines", sines)):
        if (t.shape != (cfg.theta_dis,) or t.dtype != poses.dtype
                or t.device != poses.device):
            raise ValueError(f"{name} must be ({cfg.theta_dis},) {poses.dtype} on "
                             f"{poses.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    lead = tuple(poses.shape[:-1])
    if midx is not None:
        midx = torch.broadcast_to(midx, lead)
    args, midx = _map_args(tmap, poses.dtype, poses.device, midx, lead)
    rows = math.prod(lead)
    b_n = cfg.num_beams
    out = torch.empty(lead + (b_n,), dtype=poses.dtype, device=poses.device)
    if out.numel() == 0:
        return out
    poses, cosines, sines = (v.contiguous() for v in (poses, cosines, sines))
    theta_dis = cfg.theta_dis
    err = _lib().march_beams_launch(
        poses.data_ptr(), cosines.data_ptr(), sines.data_ptr(), rows, b_n, theta_dis,
        cfg.fov / 2.0, theta_dis / (2.0 * math.pi),
        theta_dis * (cfg.fov / (b_n - 1)) / (2.0 * math.pi), *args, cfg.eps,
        cfg.max_range, cfg.march_iters, double, out.data_ptr(),
        torch._C._cuda_getCurrentRawStream(poses.device.index))
    if err != 0:
        raise RuntimeError(f"march kernel launch failed: CUDA error {err}")
    march_beams.launches += 1
    return out


march_beams.launches = 0


def reset_launches() -> None:
    march.launches = 0
    march_beams.launches = 0
