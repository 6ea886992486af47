"""Procedural race-track generator (host-side tooling).

PyTorch-package counterpart of ``red_gym_tpu/maps/trackgen.py`` (itself
after the reference's CarRacing-derived generator,
gym/f110_gym/unittest/random_trackgen.py:56-234): random radial checkpoints
-> periodic smoothing -> resampled centerline -> the corridor rasterized
-> ROS-style map yaml + png + centerline/raceline CSV (the waypoint schema
of examples/config_example_map.yaml: columns [s; x; y; theta; kappa; v; a]).

The geometry is the JAX package's numpy code, so the same seed gives the
same centerline, speeds and CSV bytes.  The corridor is drawn without
OpenCV: :func:`thick_closed_polyline` redoes ``cv2.polylines(...,
isClosed=True, thickness=t, lineType=LINE_8)`` in integer arithmetic (each
segment a filled quad in 16-bit fixed point with its 8-connected outline,
and a filled disc at every joint), and the PNG is written by
``maps.loader.encode_png``, so the module needs neither cv2 nor Pillow.

Usage:
    python -m red_gym_tpu_torch.maps.trackgen --seed 123 --n 3 --outdir <dir>
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from red_gym_tpu_torch.maps.loader import encode_png

_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def _periodic_smooth(xy: np.ndarray, harmonics: int = 8) -> np.ndarray:
    """Low-pass the closed checkpoint loop with a truncated Fourier series."""
    n = xy.shape[0]
    fx = np.fft.rfft(xy[:, 0])
    fy = np.fft.rfft(xy[:, 1])
    fx[harmonics + 1:] = 0
    fy[harmonics + 1:] = 0
    return np.stack([np.fft.irfft(fx, n), np.fft.irfft(fy, n)], axis=1)


def generate_centerline(seed: int, n_checkpoints: int = 14,
                        radius: float = 18.0, rad_jitter: float = 0.32,
                        n_points: int = 600) -> np.ndarray:
    """Closed smooth centerline (n_points, 2), roughly `radius`-sized."""
    rng = np.random.default_rng(seed)
    ang = np.sort(rng.uniform(0, 2 * np.pi, n_checkpoints))
    rad = radius * (1 + rng.uniform(-rad_jitter, rad_jitter, n_checkpoints))
    pts = np.stack([rad * np.cos(ang), rad * np.sin(ang)], axis=1)
    pts = np.repeat(pts, max(1, n_points // n_checkpoints), axis=0)
    smooth = _periodic_smooth(pts, harmonics=max(4, n_checkpoints // 2))

    # arc-length resample to uniform spacing
    d = np.linalg.norm(np.diff(smooth, axis=0, append=smooth[:1]), axis=1)
    s = np.concatenate([[0], np.cumsum(d)])[:-1]
    s_new = np.linspace(0, s[-1] + d[-1], n_points, endpoint=False)
    x = np.interp(s_new, np.concatenate([s, [s[-1] + d[-1]]]),
                  np.concatenate([smooth[:, 0], smooth[:1, 0]]))
    y = np.interp(s_new, np.concatenate([s, [s[-1] + d[-1]]]),
                  np.concatenate([smooth[:, 1], smooth[:1, 1]]))
    return np.stack([x, y], axis=1)


def _normals(center: np.ndarray) -> np.ndarray:
    t = np.roll(center, -1, axis=0) - np.roll(center, 1, axis=0)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    return np.stack([-t[:, 1], t[:, 0]], axis=1)


def _hline(img, y: int, x1: int, x2: int) -> None:
    h, w = img.shape
    if 0 <= y < h:
        x1, x2 = max(x1, 0), min(x2, w - 1)
        if x1 <= x2:
            img[y, x1:x2 + 1] = 255


def _disc(img, cx: int, cy: int, radius: int) -> None:
    """OpenCV's filled ``Circle``: the midpoint circle, spans filled."""
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        _hline(img, cy - dy, cx - dx, cx + dx)
        _hline(img, cy + dy, cx - dx, cx + dx)
        _hline(img, cy - dx, cx - dy, cx + dy)
        _hline(img, cy + dx, cx - dy, cx + dy)
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _line2(img, p1, p2) -> None:
    """OpenCV's ``Line2``: an 8-connected line between 16.16 fixed-point
    points (every end inside the image here, so no clipping)."""
    h, w = img.shape
    (x1, y1), (x2, y2) = p1, p2
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            x1, y1, x2, y2, dy = x2, y2, x1, y1, -dy
        step = (dy << _XY_SHIFT) // (ax | 1) if dy >= 0 else -((-dy << _XY_SHIFT) // (ax | 1))
        n = (x2 - x1) >> _XY_SHIFT
        xs = ((x1 + (_XY_ONE >> 1)) >> _XY_SHIFT) + np.arange(n + 1)
        ys = (y1 + (_XY_ONE >> 1) + step * np.arange(n + 1, dtype=np.int64)) >> _XY_SHIFT
    else:
        if dy < 0:
            x1, y1, x2, y2, dx = x2, y2, x1, y1, -dx
        step = (dx << _XY_SHIFT) // (ay | 1) if dx >= 0 else -((-dx << _XY_SHIFT) // (ay | 1))
        n = (y2 - y1) >> _XY_SHIFT
        ys = ((y1 + (_XY_ONE >> 1)) >> _XY_SHIFT) + np.arange(n + 1)
        xs = (x1 + (_XY_ONE >> 1) + step * np.arange(n + 1, dtype=np.int64)) >> _XY_SHIFT
    xs = np.append(xs, (x2 + (_XY_ONE >> 1)) >> _XY_SHIFT)
    ys = np.append(ys, (y2 + (_XY_ONE >> 1)) >> _XY_SHIFT)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = 255


def _fill_convex(img, pts) -> None:
    """OpenCV's ``FillConvexPoly`` of a 16.16 fixed-point convex polygon
    (LINE_8): its outline by :func:`_line2`, then one span a pixel row
    between the two edge walkers."""
    h, w = img.shape
    n = len(pts)
    delta = _XY_ONE >> 1
    for i in range(n):
        _line2(img, pts[i - 1], pts[i])
    ys = [p[1] for p in pts]
    imin = int(np.argmin(ys))
    ymin = (min(ys) + delta) >> _XY_SHIFT
    ymax = min((max(ys) + delta) >> _XY_SHIFT, h - 1)
    xmin = (min(p[0] for p in pts) + delta) >> _XY_SHIFT
    xmax = (max(p[0] for p in pts) + delta) >> _XY_SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    edges = n
    edge = [dict(idx=imin, di=1, x=-_XY_ONE, dx=0, ye=ymin),
            dict(idx=imin, di=n - 1, x=-_XY_ONE, dx=0, ye=ymin)]
    y = ymin
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0 = e["idx"]
                idx = (idx0 + e["di"]) % n
                while edges > 0:
                    edges -= 1
                    ty = (pts[idx][1] + delta) >> _XY_SHIFT
                    if ty > y:
                        xs, xe = pts[idx0][0], pts[idx][0]
                        num, den = (xe - xs) * 2 + (ty - y), 2 * (ty - y)
                        e.update(ye=ty, x=xs, idx=idx,
                                 dx=-((-num) // den) if num < 0 else num // den)
                        break
                    idx0 = idx
                    idx = (idx + e["di"]) % n
                else:
                    edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0]["x"] > edge[1]["x"] else (0, 1)
            xx1 = (edge[left]["x"] + delta) >> _XY_SHIFT
            xx2 = (edge[right]["x"] + delta) >> _XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                img[y, max(xx1, 0):min(xx2, w - 1) + 1] = 255
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


def thick_closed_polyline(img: np.ndarray, pts: np.ndarray, thickness: int) -> None:
    """Draw the closed polyline ``pts`` (N, 2) int32 (x, y) with value 255
    and ``thickness`` > 1 into the uint8 image ``img``, in place, as
    ``cv2.polylines(img, [pts], True, 255, thickness, cv2.LINE_8)`` draws
    it (OpenCV's ThickLine): a filled quad a segment, offset by the
    rounded normal of half the thickness in 16.16 fixed point, and a
    filled disc of radius (thickness + 1) // 2 at each segment's end."""
    t_fix = thickness << (_XY_SHIFT - 1)
    odd = thickness & 1
    pts = [(int(x) << _XY_SHIFT, int(y) << _XY_SHIFT) for x, y in pts]
    p0 = pts[-1]
    for p1 in pts:
        dx = (p0[0] - p1[0]) / _XY_ONE
        dy = (p1[1] - p0[1]) / _XY_ONE
        r = dx * dx + dy * dy
        if abs(r) > np.finfo(np.float64).eps:
            r = (t_fix + odd * _XY_ONE * 0.5) / np.sqrt(r)
            ddx, ddy = int(np.rint(dy * r)), int(np.rint(dx * r))   # cvRound: half to even
            _fill_convex(img, [(p0[0] + ddx, p0[1] + ddy), (p0[0] - ddx, p0[1] - ddy),
                               (p1[0] - ddx, p1[1] - ddy), (p1[0] + ddx, p1[1] + ddy)])
        _disc(img, (p1[0] + (_XY_ONE >> 1)) >> _XY_SHIFT,
              (p1[1] + (_XY_ONE >> 1)) >> _XY_SHIFT, (t_fix + (_XY_ONE >> 1)) >> _XY_SHIFT)
        p0 = p1


def rasterize_track(center: np.ndarray, half_width: float = 2.6,
                    resolution: float = 0.0625, margin: float = 5.0):
    """Occupancy image (255 = drivable corridor) + origin, reference map
    conventions (white free space, row 0 at the map bottom).  The corridor
    is the centerline drawn as a closed thick polyline
    (:func:`thick_closed_polyline`), i.e. every pixel within half_width of
    the centerline."""
    lo = center.min(axis=0) - (half_width + margin)
    hi = center.max(axis=0) + (half_width + margin)
    w = int(np.ceil((hi[0] - lo[0]) / resolution))
    h = int(np.ceil((hi[1] - lo[1]) / resolution))

    img = np.zeros((h, w), np.uint8)
    pts = np.rint((center - lo) / resolution).astype(np.int32)
    thickness = max(1, int(round(2 * half_width / resolution)))
    if thickness < 2:
        raise ValueError("the corridor must be at least 2 px wide")
    thick_closed_polyline(img, pts, thickness)
    origin = (float(lo[0]), float(lo[1]), 0.0)
    return img, origin


def speed_profile(center: np.ndarray, v_max: float = 7.0, v_min: float = 2.5,
                  a_lat: float = 6.0) -> np.ndarray:
    """Curvature-limited target speeds along the centerline."""
    d1 = (np.roll(center, -1, axis=0) - np.roll(center, 1, axis=0)) / 2.0
    d2 = np.roll(center, -1, axis=0) - 2 * center + np.roll(center, 1, axis=0)
    cross = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    denom = np.maximum(np.linalg.norm(d1, axis=1) ** 3, 1e-9)
    kappa = np.abs(cross) / denom
    v = np.sqrt(a_lat / np.maximum(kappa, 1e-6))
    # smooth the profile a little so it is trackable
    for _ in range(10):
        v = np.minimum(v, 0.5 * (np.roll(v, 1) + np.roll(v, -1)) + 0.3)
    return np.clip(v, v_min, v_max)


def save_track(outdir: str, name: str, center: np.ndarray, img: np.ndarray,
               origin, resolution: float = 0.0625):
    """Write ``name``.png (the image flipped so row 0 is the map's top),
    ``name``.yaml and ``name``_waypoints.csv under ``outdir``; returns the
    yaml path."""
    os.makedirs(outdir, exist_ok=True)
    encode_png(os.path.join(outdir, f"{name}.png"), np.flipud(img))
    with open(os.path.join(outdir, f"{name}.yaml"), "w") as f:
        f.write(f"image: {name}.png\n"
                f"resolution: {resolution:.6f}\n"
                f"origin: [{origin[0]:.8f},{origin[1]:.8f}, 0.000000]\n"
                "negate: 0\noccupied_thresh: 0.45\nfree_thresh: 0.196\n")

    # raceline CSV in the reference waypoint schema (s; x; y; theta; kappa; v; a)
    d = np.linalg.norm(np.diff(center, axis=0, prepend=center[:1]), axis=1)
    s = np.cumsum(d)
    theta = np.arctan2(*np.flip((np.roll(center, -1, axis=0) - center).T, 0))
    v = speed_profile(center)
    rows = np.stack([s, center[:, 0], center[:, 1], theta,
                     np.zeros_like(s), v, np.zeros_like(s)], axis=1)
    hdr = "# s_m; x_m; y_m; psi_rad; kappa_radpm; vx_mps; ax_mps2\n# \n# generated by red_gym_tpu.maps.trackgen\n"
    with open(os.path.join(outdir, f"{name}_waypoints.csv"), "w") as f:
        f.write(hdr)
        for row in rows:
            f.write(";".join(f"{x:.7f}" for x in row) + "\n")
    return os.path.join(outdir, f"{name}.yaml")


def generate(outdir: str, seed: int = 0, name: str | None = None,
             half_width: float = 2.6, **kw) -> str:
    """Generate, rasterize and save one track; returns its yaml path."""
    center = generate_centerline(seed, **{k: v for k, v in kw.items()
                                          if k in ("n_checkpoints", "radius",
                                                   "rad_jitter", "n_points")})
    img, origin = rasterize_track(center, half_width=half_width)
    return save_track(outdir, name or f"track_{seed:04d}", center, img, origin)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Generate random race tracks "
                                 "(map yaml + png + waypoint CSV).")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=1)
    ap.add_argument("--outdir", type=str, default=".",
                    help="output directory (default: the current one)")
    ap.add_argument("--half-width", type=float, default=2.6,
                    help="track corridor half width [m]")
    ap.add_argument("--checkpoints", type=int, default=14,
                    help="number of layout checkpoints (more = twistier)")
    ap.add_argument("--name", type=str, default=None)
    args = ap.parse_args(argv)
    for i in range(args.n):
        path = generate(args.outdir, seed=args.seed + i, name=args.name,
                        half_width=args.half_width,
                        n_checkpoints=args.checkpoints)
        print("wrote", path)


if __name__ == "__main__":
    main()
