"""Lidar-scan -> occupancy-bitmap rasterization on the scan's device.

PyTorch counterpart of ``red_gym_tpu/ops/rasterize.py`` (reference:
weap_util/weap_util/lidar.py:4-155), with its names and defaults.  The
polygon fill and the segment draw run on the kernels of
``ops/raster_kernels.py`` (their plain twins on the CPU); the endpoints,
the RAYS endpoint squares, the centre marker and the channels are plain
tensor code.  Every function is batched over the scan's leading dims.

Pixels equal the JAX package's: the endpoints round as XLA's compiled
expression does (the constant ``scaling_factor * cos(angle)`` folded first,
then one product and one sum), the fill's crossing abscissa divides in
float32, and the sample points of a segment round as one fused
multiply-add, as XLA's CPU code computes them.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from red_gym_tpu_torch.ops import raster_kernels as rk


@functools.lru_cache(maxsize=None)
def _endpoint_tables(n: int, num_beams_out: int, scaling_factor: float, starting_angle: float,
                     fov: float, winding_dir: str, dtype: torch.dtype, device):
    """(beam index, sf*cos, sf*sin): the static gather and the two constant
    factors of the endpoint expression, rounded as XLA folds them (the
    angle cast to the scan's dtype, its cos/sin correctly rounded, then the
    product with the scaling factor in that dtype)."""
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    idx = np.linspace(0, n - 1, num_beams_out).astype(int)
    direction = 1.0 if winding_dir == "CCW" else -1.0
    angles = (starting_angle + direction * fov * np.linspace(0, 1, num_beams_out)).astype(np_dt)
    sf = np_dt(scaling_factor)
    sc = (sf * np.cos(angles.astype(np.float64)).astype(np_dt)).astype(np_dt)
    ss = (sf * np.sin(angles.astype(np.float64)).astype(np_dt)).astype(np_dt)
    return (torch.from_numpy(idx).to(device), torch.from_numpy(sc).to(device),
            torch.from_numpy(ss).to(device))


def beam_endpoints(scan, num_beams_out: int, out_dims, scaling_factor,
                   starting_angle=-math.pi / 2, fov=2 * math.pi,
                   winding_dir="CCW"):
    """Downsample the scan (..., n) and convert to integer pixel endpoints
    (..., num_beams_out, 2) int32 in cv2 (x, y) order, matching the
    reference's index/rounding pipeline (weap_util/lidar.py:70-83)."""
    if scan.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"scan must be float32 or float64, got {scan.dtype}")
    idx, sc, ss = _endpoint_tables(scan.shape[-1], num_beams_out, scaling_factor,
                                   starting_angle, fov, winding_dir, scan.dtype,
                                   scan.device)
    data = scan[..., idx]
    cy, cx = out_dims[0] // 2, out_dims[1] // 2
    px = torch.round(data * sc + cy).to(torch.int32)
    py = torch.round(data * ss + cx).to(torch.int32)
    return torch.stack([px, py], dim=-1)


def _squares(points, out_dims):
    """Flat pixel indices (N, K * 25) of the 5x5 endpoint squares of RAYS
    (reference cv2.rectangle(p-2, p+2, ..., -1)), clipped to the canvas."""
    h, w = out_dims
    offs = torch.arange(-2, 3, device=points.device, dtype=torch.int32)
    dy, dx = torch.meshgrid(offs, offs, indexing="ij")
    sq_x = torch.clamp(points[..., None, 0] + dx.reshape(-1), 0, w - 1)
    sq_y = torch.clamp(points[..., None, 1] + dy.reshape(-1), 0, h - 1)
    return (sq_y * w + sq_x).reshape(points.shape[0], -1).long()


def lidar_to_bitmap(scan, winding_dir: str = "CCW",
                    starting_angle: float = -math.pi / 2,
                    max_scan_radius: float | None = None,
                    scaling_factor: float | None = 10.0,
                    bg_color: str = "white", draw_center: bool = True,
                    output_image_dims: tuple = (256, 256),
                    target_beam_count: int = 600, fov: float = 2 * math.pi,
                    draw_mode: str = "FILL", channels: int = 1):
    """uint8 bitmap of lidar scans (..., n) -> (..., H, W) (channels 1) or
    (..., H, W, channels) (reference weap_util/lidar.py:99-155).

    draw_mode: 'FILL' | 'POLYGON' | 'RAYS'; channels: 1 | 3 | 4."""
    assert winding_dir in ("CW", "CCW")
    assert bg_color in ("black", "white")
    assert draw_mode in ("RAYS", "POLYGON", "FILL")
    assert channels in (1, 3, 4)

    if max_scan_radius is not None:
        scaling_factor = min(output_image_dims) / max_scan_radius
    elif scaling_factor is None:
        raise ValueError("provide either max_scan_radius or scaling_factor")

    h, w = output_image_dims
    bg, fg = (0, 255) if bg_color == "black" else (255, 0)
    lead = scan.shape[:-1]
    points = beam_endpoints(scan, target_beam_count, output_image_dims, scaling_factor,
                            starting_angle, fov, winding_dir)
    points = points.reshape(-1, target_beam_count, 2)
    t = rk.segment_t(points.device)
    if draw_mode == "FILL":
        mask = rk.fill_polygon(points, output_image_dims)
    else:
        mask = torch.zeros((points.shape[0], h, w), dtype=torch.uint8, device=points.device)
    if draw_mode == "RAYS":
        center = torch.tensor([h // 2, w // 2], dtype=torch.int32, device=points.device)
        rk.draw_segments(mask, center.expand_as(points), points, t)
        mask.view(points.shape[0], -1).scatter_(1, _squares(points, output_image_dims), 1)
    else:   # the closed outline, on the fill too
        rk.draw_segments(mask, points, torch.roll(points, -1, dims=-2), t)

    colors = torch.tensor([bg, fg], dtype=torch.uint8, device=mask.device)
    img = torch.where(mask.bool(), colors[1], colors[0])
    if draw_center:
        cy, cx = h // 2, w // 2
        img[:, cy - 2:cy + 3, cx - 2:cx + 3] = bg if draw_mode == "FILL" else fg
    img = img.reshape(lead + (h, w))
    if channels == 1:
        return img
    if channels == 3:
        return torch.stack([img] * 3, dim=-1)
    return torch.stack([img, img, img, torch.full_like(img, 255)], dim=-1)


def scans_to_legacy_tensors(scans, max_range: float = 30.0,
                            grid_size: int = 256,
                            bound: float = 10.0) -> np.ndarray:
    """Reference dataset-collector tensor layout, vectorized, in numpy: the
    port's copy of the JAX package's function (reference:
    f1tenth_gym/examples/lidar.py:214-244, np.savez_compressed at 255-257).

    Each beam's hit point of an (N, B) batch of scans is scattered into an
    (N, grid_size, grid_size) uint8 occupancy tensor: beam angles fixed at
    linspace(-135 deg, 135 deg) whatever the env fov, x forward mapped to
    ROWS, beams at/after ``max_range`` or outside the +-``bound`` m box
    skipped, plain int() truncation of the pixel coordinate."""
    scans = np.asarray(scans, np.float64)
    n, b = scans.shape
    angles = np.linspace(-135.0, 135.0, b) * np.pi / 180.0
    x = scans * np.cos(angles)
    y = scans * np.sin(angles)
    keep = ((scans < max_range)
            & (x >= -bound) & (x <= bound) & (y >= -bound) & (y <= bound))
    span = 2.0 * bound
    # int() truncation (values are >= 0 here, so trunc == floor) then the
    # reference's redundant clip
    i_row = np.clip(((x + bound) / span * (grid_size - 1)).astype(np.int64),
                    0, grid_size - 1)
    i_col = np.clip(((y + bound) / span * (grid_size - 1)).astype(np.int64),
                    0, grid_size - 1)
    out = np.zeros((n, grid_size, grid_size), np.uint8)
    n_idx = np.broadcast_to(np.arange(n)[:, None], (n, b))
    out[n_idx[keep], i_row[keep], i_col[keep]] = 1
    return out
