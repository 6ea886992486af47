"""The rasterizer's polygon fill and segment draw, as CUDA kernels.

Replace no TPU kernel: the JAX package rasterizes a lidar bitmap with a
broadcast that XLA fuses (``red_gym_tpu/ops/rasterize.py:43-82``).  Its
crossing-number fill compares every pixel with every polygon edge, (H, W, K)
= 256 x 256 x 600 an image; in eager PyTorch that array would be built, 10
GB of float32 for the 64 images of a planning step.  So here the fill and
the segment draw are kernels (``red_gym_tpu_torch/csrc/rasterize.cu``) and
their plain twins are chunked:

- :func:`fill_polygon`: points (N, K, 2) int32 (x, y) of N closed polygons
  -> (N, H, W) uint8, 1 where the pixel's crossing count is odd
  (JAX ``_fill_polygon`` without its outline);
- :func:`draw_segments`: stores 1 into a (N, H, W) uint8 mask at the
  pixels of ``samples`` points along each segment (JAX ``_draw_segments``),
  in place.

On CUDA tensors both launch their kernel or raise, never a fallback; on
CPU tensors they run the twins :func:`fill_polygon_reference` and
:func:`draw_segments_reference`.  ``fill_polygon.launches`` and
``draw_segments.launches`` count kernel launches.  Kernels and twins round
every operation as XLA's CPU code does (the sample point's one fused
multiply-add included), so they agree bit for bit with each other and
pixel for pixel with the JAX package.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from red_gym_tpu_torch.ops import _build

SEGMENT_SAMPLES = 448
# the twins' largest boolean intermediate, in elements: about 64 MB each
_TWIN_ELEMS = 1 << 26


@functools.lru_cache(maxsize=None)
def segment_t(device: torch.device) -> torch.Tensor:
    """The draw's SEGMENT_SAMPLES sample positions on ``device``,
    ``jnp.linspace(0, 1, 448, float32)`` exactly: i * float32(1 / 447), the
    last one 1.  (torch.linspace and a float64 table cast to float32 each
    differ from it in some entries.)"""
    n = SEGMENT_SAMPLES
    t = np.arange(n, dtype=np.float32) * np.float32(1.0 / (n - 1))
    t[-1] = 1.0
    return torch.from_numpy(t).to(device)


def _check_points(points, name: str) -> None:
    if points.dtype != torch.int32 or points.dim() != 3 or points.shape[-1] != 2:
        raise ValueError(f"{name} must be (N, K, 2) int32, got {points.dtype} "
                         f"{tuple(points.shape)}")


def fill_polygon_reference(points, out_dims, max_elems: int = _TWIN_ELEMS):
    """Plain twin of the fill kernel: the crossing-number test of JAX's
    ``_fill_polygon`` for N polygons (N, K, 2) int32 -> (N, H, W) uint8,
    computed over chunks of images and rows so that no (images, rows, W, K)
    intermediate holds more than ``max_elems`` elements."""
    h, w = out_dims
    n, k = points.shape[:2]
    dev = points.device
    xs = points[..., 0].to(torch.float32)
    ys = points[..., 1].to(torch.float32)
    x2 = torch.roll(xs, -1, dims=-1)
    y2 = torch.roll(ys, -1, dims=-1)
    denom = torch.where(y2 == ys, torch.ones_like(ys), y2 - ys)
    dx = x2 - xs
    px = torch.arange(w, dtype=torch.float32, device=dev)[:, None]     # (W, 1)
    out = torch.empty((n, h, w), dtype=torch.uint8, device=dev)
    n_step = max(1, max_elems // max(1, w * k))
    for i0 in range(0, n, n_step):
        i1 = min(n, i0 + n_step)
        h_step = max(1, max_elems // max(1, (i1 - i0) * w * k))
        sl = (slice(i0, i1), None, slice(None))
        for r0 in range(0, h, h_step):
            py = torch.arange(r0, min(h, r0 + h_step), dtype=torch.float32,
                              device=dev)[:, None]                    # (R, 1)
            cond = (ys[sl] > py) != (y2[sl] > py)                     # (n, R, K)
            x_int = dx[sl] * (py - ys[sl]) / denom[sl] + xs[sl]
            crossing = cond[:, :, None, :] & (px < x_int[:, :, None, :])  # (n, R, W, K)
            out[i0:i1, r0:r0 + py.shape[0]] = (crossing.sum(-1) % 2).to(torch.uint8)
    return out


def draw_segments_reference(mask, starts, ends, t, max_elems: int = _TWIN_ELEMS):
    """Plain twin of the draw kernel: starts, ends (N, K, 2) int32 segments
    of image n; a 1 stored into ``mask`` (N, H, W) uint8, in place, at each
    of the len(t) points s * (1 - t) + e * t, rounded as one fused
    multiply-add (the float64 sum of the exact product s * (1 - t) and the
    float32 e * t is exact, so one rounding to float32 gives it), then rint
    and clipped to the canvas.  Returns ``mask``."""
    n, k = starts.shape[:2]
    h, w = mask.shape[-2:]
    tt = t[:, None]
    omt = (1.0 - tt).to(torch.float64)
    flat_mask = mask.view(-1)
    seg = starts.reshape(-1, 2)
    end = ends.reshape(-1, 2)
    base = torch.arange(n, device=mask.device, dtype=torch.int64) * (h * w)
    base = base.repeat_interleave(k)                      # each segment's image offset
    step = max(1, max_elems // max(1, 2 * t.numel()))
    for i0 in range(0, seg.shape[0], step):
        s = seg[i0:i0 + step, None, :].to(torch.float32)
        e = end[i0:i0 + step, None, :].to(torch.float32)
        pts = (s.to(torch.float64) * omt + (e * tt).to(torch.float64)).to(torch.float32)
        pix = torch.round(pts).to(torch.int64)
        x = pix[..., 0].clamp(0, w - 1)
        y = pix[..., 1].clamp(0, h - 1)
        flat_mask[(base[i0:i0 + step, None] + y * w + x).reshape(-1)] = 1
    return mask


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("rasterize")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fill_polygon_launch.argtypes = [p, i, i, i, i, p, p]
    lib.fill_polygon_launch.restype = ctypes.c_int
    lib.draw_segments_launch.argtypes = [p, p, i, i, p, i, i, i, p, p]
    lib.draw_segments_launch.restype = ctypes.c_int
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def fill_polygon(points, out_dims):
    """The fill kernel on a CUDA device, its twin
    (:func:`fill_polygon_reference`) on the CPU: (N, K, 2) int32 -> (N, H,
    W) uint8, 1 inside each polygon (its outline not drawn)."""
    _check_points(points, "points")
    if points.device.type == "cpu":
        return fill_polygon_reference(points, out_dims)
    if points.device.type != "cuda":
        raise ValueError(f"fill_polygon runs on cuda or cpu, not {points.device}")
    h, w = out_dims
    n, k = points.shape[:2]
    if n > 65535:
        raise ValueError(f"the fill kernel takes at most 65535 images, got {n}")
    out = torch.empty((n, h, w), dtype=torch.uint8, device=points.device)
    if out.numel() == 0 or k == 0:
        return out.zero_()
    points = points.contiguous()
    err = _lib().fill_polygon_launch(points.data_ptr(), n, k, h, w, out.data_ptr(),
                                     _stream(points))
    if err != 0:
        raise RuntimeError(f"fill_polygon kernel launch failed: CUDA error {err}")
    fill_polygon.launches += 1
    return out


fill_polygon.launches = 0


def draw_segments(mask, starts, ends, t):
    """The draw kernel on a CUDA device, its twin
    (:func:`draw_segments_reference`) on the CPU: 1 stored into ``mask``
    (N, H, W) uint8 at the samples ``t`` (float32) of the segments starts
    -> ends (N, K, 2) int32 of each image, in place -> ``mask``."""
    _check_points(starts, "starts")
    _check_points(ends, "ends")
    if starts.shape != ends.shape or starts.shape[0] != mask.shape[0]:
        raise ValueError(f"starts {tuple(starts.shape)} and ends {tuple(ends.shape)} must "
                         f"be (N, K, 2) for the N = {mask.shape[0]} images of the mask")
    if mask.dtype != torch.uint8 or mask.dim() != 3 or not mask.is_contiguous():
        raise ValueError(f"mask must be a contiguous (N, H, W) uint8, got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    if mask.device.type == "cpu":
        return draw_segments_reference(mask, starts, ends, t)
    if mask.device.type != "cuda":
        raise ValueError(f"draw_segments runs on cuda or cpu, not {mask.device}")
    if t.dtype != torch.float32 or t.device != mask.device or t.dim() != 1:
        raise ValueError("t must be a (samples,) float32 tensor on the mask's device")
    for name, v in (("starts", starts), ("ends", ends)):
        if v.device != mask.device:
            raise ValueError(f"{name} is on {v.device}, the mask on {mask.device}")
    n, k = starts.shape[:2]
    if n * k == 0 or t.numel() == 0 or mask.numel() == 0:
        return mask
    h, w = mask.shape[-2:]
    starts, ends, t = starts.contiguous(), ends.contiguous(), t.contiguous()
    err = _lib().draw_segments_launch(starts.data_ptr(), ends.data_ptr(), n, k,
                                      t.data_ptr(), t.numel(), h, w, mask.data_ptr(),
                                      _stream(mask))
    if err != 0:
        raise RuntimeError(f"draw_segments kernel launch failed: CUDA error {err}")
    draw_segments.launches += 1
    return mask


draw_segments.launches = 0


def reset_launches() -> None:
    fill_polygon.launches = 0
    draw_segments.launches = 0
