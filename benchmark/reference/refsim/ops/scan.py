"""Lidar tables and the exact scan: the sphere march on the map's distance
transform.

PyTorch counterpart of ``red_gym_tpu/ops/scan.py`` (reference:
gym/f110_gym/envs/laser_models.py:56-186, 429-454).  The march serves the
exact scan, ``scan_mode="exact"`` (SimConfig's default), at every step
(:func:`trace`, :func:`scan`), and the fast scan's range-texture build
(:func:`march`, :func:`trace_angles`).  On a CUDA device both run the march
kernel of ``ops/march_kernels.py``, on the CPU its plain twin; every ray
runs the reference's arithmetic, so in float64 the ranges match the JAX
march.  :func:`march` and :func:`trace` take a stack of maps
(``maps.loader.stack_maps``) with a map index ``midx`` per ray or per pose
(multi-map batches); the texture build marches one raw map.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from refsim.config import SimConfig, resolve_device
from refsim.maps.loader import TrackMap
from refsim.ops import march_kernels
# the march's cell lookup and theta indices live beside its kernel; they are
# this module's names in the JAX package
from refsim.ops.march_kernels import (  # noqa: F401
    beam_theta_indices, dt_lookup, map_scalars)


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
                 device="cuda") -> ScanTables:
    """Host-side float64 precompute, the same numpy math as the JAX package,
    stored on ``device`` (the card unless the caller passes "cpu")."""
    device = resolve_device(device)
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


def march(x, y, c, s, tmap: TrackMap, cfg: SimConfig, midx=None):
    """Sphere march from points (x, y) along directions (c, s), all of one
    shape (reference trace_ray, laser_models.py:107-146): step the full safe
    distance until within eps of an obstacle or beyond max_range, then
    clamp to max_range; ``cfg.march_iters > 0`` caps the iterations.
    ``midx`` (int32, x's shape) marches each ray on its map of a stack.
    The march kernel on a CUDA device, its twin on the CPU
    (``march_kernels.march``)."""
    return march_kernels.march(x, y, c, s, tmap, cfg, midx)


def trace(pose, tables: ScanTables, tmap: TrackMap, cfg: SimConfig, midx=None):
    """Noiseless scan of pose(s) (..., 3) -> (..., num_beams) along the
    theta-discretized beam table (reference get_scan, laser_models.py:
    149-186), with ``midx`` (...) int32 each pose on its map of a stack:
    the march kernel's beams form on a CUDA device, its twin on the CPU
    (``march_kernels.march_beams``)."""
    return march_kernels.march_beams(pose, tables.cosines, tables.sines, tmap, cfg,
                                     midx)


def trace_angles(origins, angles, tmap: TrackMap, cfg: SimConfig):
    """Scan at exact world angles: origins (..., 2), angles (T,) ->
    (..., T).  Builds the fast scan's range texture."""
    shape = origins.shape[:-1] + angles.shape
    x = torch.broadcast_to(origins[..., 0:1], shape)
    y = torch.broadcast_to(origins[..., 1:2], shape)
    return march(x, y, torch.cos(angles), torch.sin(angles), tmap, cfg)


def scan(pose, gen: Optional[torch.Generator], tables: ScanTables,
         tmap: TrackMap, cfg: SimConfig):
    """Scan with gaussian beam noise (reference laser_models.py:429-454):
    :func:`trace`, plus ``cfg.scan_noise_std`` times a standard normal draw
    from ``gen`` for every beam.  ``gen`` None gives the noiseless scan (the
    JAX package takes a key where this takes a generator)."""
    out = trace(pose, tables, tmap, cfg)
    if gen is not None and cfg.scan_noise_std > 0:
        out = out + cfg.scan_noise_std * torch.randn(
            out.shape, generator=gen, dtype=out.dtype, device=out.device)
    return out
