"""Bitmap-based reward helpers for the SAL training stack.

PyTorch counterpart of ``red_gym_tpu/ops/bitmap_rewards.py`` (reference:
src/SAL.py:766-935): pixel-neighbourhood collision test, Sobel-gradient wall
normals, collision-angle penalty, and row-scan centreline distance/reward.
Each takes a batch of bitmaps (E, H, W) and one car pixel per env
(``car_x``, ``car_y`` (E,) integers) and returns one value per env; no loop
over envs.

Values that the JAX package computes with a weak Python float against an
integer (the run's midpoint, the interpolation knots) come out in float64
here, as they do in the JAX package with 64-bit types enabled.

Deviation note (as in the JAX package): the reference gates wall-normal
estimation on cv2.Canny edges; here edge pixels are gradient-magnitude-
thresholded Sobel responses (no hysteresis), which selects the same wall
boundaries on binary bitmaps.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def detect_collision(fill_bitmap, car_x, car_y, neighborhood: int = 1):
    """True where any white (255) pixel neighbours (car_x, car_y), the centre
    pixel excluded (reference detect_collison, SAL.py:766-790) -> (E,) bool."""
    h, w = fill_bitmap.shape[-2:]
    dev = fill_bitmap.device
    offs = torch.arange(-neighborhood, neighborhood + 1, device=dev)
    dy, dx = torch.meshgrid(offs, offs, indexing="ij")
    keep = ~((dx == 0) & (dy == 0)).reshape(-1)
    nx = car_x.long()[:, None] + dx.reshape(-1)
    ny = car_y.long()[:, None] + dy.reshape(-1)
    inb = (nx >= 0) & (nx < w) & (ny >= 0) & (ny < h)
    e = torch.arange(fill_bitmap.shape[0], device=dev)[:, None]
    vals = fill_bitmap[e, ny.clamp(0, h - 1), nx.clamp(0, w - 1)]
    return torch.any(keep & inb & (vals == 255), dim=-1)


def _sobel(img):
    """Sobel gradients (gx, gy) of (E, H, W) images with edge padding, float32."""
    f = img.to(torch.float32)
    p = F.pad(f[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    gx = (p[:, 0:-2, 2:] + 2 * p[:, 1:-1, 2:] + p[:, 2:, 2:]
          - p[:, 0:-2, 0:-2] - 2 * p[:, 1:-1, 0:-2] - p[:, 2:, 0:-2])
    gy = (p[:, 2:, 0:-2] + 2 * p[:, 2:, 1:-1] + p[:, 2:, 2:]
          - p[:, 0:-2, 0:-2] - 2 * p[:, 0:-2, 1:-1] - p[:, 0:-2, 2:])
    return gx, gy


def get_wall_normal(fill_bitmap, car_x, car_y, region: int = 10,
                    edge_thresh: float = 200.0):
    """Mean unit gradient at wall-edge pixels near each car -> (E, 2)
    (reference get_wall_normal, SAL.py:793-841)."""
    h, w = fill_bitmap.shape[-2:]
    dev = fill_bitmap.device
    gx, gy = _sobel(fill_bitmap)
    mag = torch.abs(gx) + torch.abs(gy)
    ys = torch.arange(h, device=dev)[None, :, None]
    xs = torch.arange(w, device=dev)[None, None, :]
    cx, cy = car_x.long()[:, None, None], car_y.long()[:, None, None]
    in_region = ((xs >= cx - region) & (xs <= cx + region)
                 & (ys >= cy - region) & (ys <= cy + region))
    edge = (mag > edge_thresh) & in_region

    n = edge.sum(dim=(1, 2))
    den = torch.clamp(n, min=1).to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    mean_gx = torch.where(edge, gx, zero).sum(dim=(1, 2)) / den
    mean_gy = torch.where(edge, gy, zero).sum(dim=(1, 2)) / den
    norm = torch.sqrt(mean_gx ** 2 + mean_gy ** 2) + 1e-8
    normal = torch.stack([mean_gx, mean_gy], dim=-1) / norm[:, None]
    return torch.where((n > 0)[:, None], normal, torch.zeros_like(normal))


def compute_collision_angle(wall_normal, car_direction=(0.0, 1.0)):
    """Angle in degrees between the direction and each wall normal (E, 2)
    -> (E,) (reference SAL.py:844-856)."""
    d = torch.as_tensor(car_direction, dtype=wall_normal.dtype, device=wall_normal.device)
    dot = torch.clamp(wall_normal[:, 0] * d[0] + wall_normal[:, 1] * d[1], -1.0, 1.0)
    return torch.rad2deg(torch.arccos(dot))


def collision_angle_penalty(fill_bitmap, car_x, car_y):
    """0 where no collision, else an angle-scaled penalty in [-1, -0.1]
    (reference SAL.py:858-877) -> (E,) float64.  The interpolation over
    (0 deg, 0.1), (90 deg, 1.0), jnp.interp's formula written out."""
    collided = detect_collision(fill_bitmap, car_x, car_y)
    angle = torch.abs(compute_collision_angle(get_wall_normal(fill_bitmap, car_x, car_y)))
    x = angle.to(torch.float64)
    lo, hi = 0.1, 1.0
    f = lo + ((x - 0.0) / 90.0) * (hi - lo)
    f = torch.where(x < 0.0, torch.full_like(f, lo), f)
    f = torch.where(x > 90.0, torch.full_like(f, hi), f)
    return torch.where(collided, -f, torch.zeros_like(f))


def distance_from_row_center(fill_bitmap, car_x, car_y):
    """Distance from the centre of the drivable (white) run containing each
    car on its pixel row, or -1 where invalid (the reference returns None;
    SAL.py:879-919) -> (E,) float64."""
    h, w = fill_bitmap.shape[-2:]
    dev = fill_bitmap.device
    car_x, car_y = car_x.long(), car_y.long()
    row = fill_bitmap[torch.arange(fill_bitmap.shape[0], device=dev), car_y.clamp(0, h - 1)]
    white = row == 255
    idx = torch.arange(w, device=dev)[None, :]
    cx = car_x[:, None]
    left_block = torch.where(~white & (idx <= cx), idx, -1).amax(dim=-1)
    right_block = torch.where(~white & (idx >= cx), idx, w).amin(dim=-1)
    left_edge = left_block + 1
    right_edge = right_block - 1

    mid = (left_edge + right_edge).to(torch.float64) / 2.0
    dist = torch.abs(car_x - mid)
    valid = ((car_x >= 0) & (car_x < w) & (car_y >= 0) & (car_y < h)
             & (left_edge >= 0) & (right_edge < w) & (left_edge < right_edge))
    return torch.where(valid, dist, torch.full_like(dist, -1.0))


def centerline_reward(fill_bitmap, car_x, car_y, max_lane_halfwidth: float = 50.0):
    """1 at lane centre decaying to 0 at the boundary; -1 where off-track
    (reference SAL.py:921-935) -> (E,) float64."""
    dist = distance_from_row_center(fill_bitmap, car_x, car_y)
    reward = torch.clamp(1.0 - dist / max_lane_halfwidth, min=0.0)
    return torch.where(dist < 0, torch.full_like(dist, -1.0), reward)

