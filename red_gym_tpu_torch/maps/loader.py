"""Track map loading: ROS-style yaml + 8-bit PNG -> EDT -> TrackMap tensors.

PyTorch counterpart of ``red_gym_tpu/maps/loader.py``.  The map's distance
transform is computed once on the host in float64 with scipy (the fallback
the JAX package uses, ``red_gym_tpu/native/__init__.py``) and moved to the
device.  The yaml and the PNG are parsed here with the standard library, so
the package needs neither PyYAML nor Pillow.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import NamedTuple, Sequence

import numpy as np
import torch
from scipy.ndimage import distance_transform_edt

from red_gym_tpu_torch.config import resolve_device


class TrackMap(NamedTuple):
    """Device-resident map data; every field is a tensor (0-d for scalars).

    ``height``/``width`` are the true extents, which may be smaller than
    ``dt.shape`` for a padded map.  A stack of M maps (:func:`stack_maps`)
    carries every field with a leading map axis: dt (M, H, W), the scalars
    (M,)."""

    dt: torch.Tensor          # (H, W) distance to the nearest obstacle [m]
    occupancy: torch.Tensor   # (H, W) binarized map (0 obstacle, 255 free)
    orig_x: torch.Tensor      # map origin x [m]
    orig_y: torch.Tensor      # map origin y [m]
    orig_c: torch.Tensor      # cos(origin yaw)
    orig_s: torch.Tensor      # sin(origin yaw)
    resolution: torch.Tensor  # [m / cell]
    height: torch.Tensor      # int32 rows
    width: torch.Tensor       # int32 cols


def read_map_yaml(path: str) -> dict:
    """Parse the flat ``key: value`` map yaml (image, resolution, origin,
    negate, occupied_thresh, free_thresh).  Numbers become floats, a
    ``[a, b, c]`` list a list of floats, anything else stays a string."""
    meta = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            key, sep, val = line.partition(":")
            if not sep:
                raise ValueError(f"{path}: cannot parse line {line!r}")
            val = val.strip()
            if val.startswith("[") and val.endswith("]"):
                meta[key.strip()] = [float(v) for v in val[1:-1].split(",")]
                continue
            try:
                meta[key.strip()] = float(val)
            except ValueError:
                meta[key.strip()] = val.strip("'\"")
    return meta


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def decode_png(path: str) -> np.ndarray:
    """Decode a non-interlaced 8-bit grayscale PNG (every packaged map is
    one) to a uint8 array (H, W), rows top to bottom."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    width, height, depth, color, _, _, interlace = hdr
    if depth != 8 or color != 0 or interlace:
        raise ValueError(f"{path}: only non-interlaced 8-bit grayscale PNGs are "
                         f"supported (depth {depth}, color type {color}, "
                         f"interlace {interlace})")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(height, width + 1)
    out = np.zeros((height, width), np.uint8)
    prior = np.zeros(width, np.uint8)
    for r in range(height):
        kind, line = raw[r, 0], raw[r, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:     # Sub: running sum along the row
            cur = (line.cumsum(dtype=np.uint64) % 256).astype(np.uint8)
        elif kind == 2:     # Up
            cur = line + prior
        elif kind in (3, 4):  # Average / Paeth: sequential along the row
            cur = np.zeros(width, np.uint8)
            for i in range(width):
                a = int(cur[i - 1]) if i else 0
                b = int(prior[i])
                if kind == 3:
                    pred = (a + b) // 2
                else:
                    pred = _paeth(a, b, int(prior[i - 1]) if i else 0)
                cur[i] = (int(line[i]) + pred) & 0xFF
        else:
            raise ValueError(f"{path}: bad PNG filter type {kind} in row {r}")
        out[r] = cur
        prior = cur
    return out


def load_map_image(image_path: str) -> np.ndarray:
    """Image -> binarized float64 occupancy grid, reference pipeline
    (laser_models.py:398-404): flip top-bottom, threshold at 128."""
    img = decode_png(image_path)[::-1].astype(np.float64)
    return np.where(img <= 128.0, 0.0, 255.0)


def load_map(map_yaml_path: str, map_ext: str = ".png",
             dtype=torch.float32, device="cuda",
             pad_to: tuple[int, int] | None = None) -> TrackMap:
    """Load yaml + image, compute the EDT on the host, return a TrackMap
    with its tensors on ``device`` (the card unless the caller passes
    "cpu").  ``pad_to`` = (H, W) pads the map after the EDT
    (:func:`pad_map`)."""
    device = resolve_device(device)
    meta = read_map_yaml(map_yaml_path)
    resolution = float(meta["resolution"])
    origin = meta["origin"]
    occ = load_map_image(os.path.splitext(map_yaml_path)[0] + map_ext)
    h, w = occ.shape
    dt = resolution * distance_transform_edt(occ)

    def t(v, dt_=dtype):
        return torch.as_tensor(v, dtype=dt_, device=device)

    tmap = TrackMap(dt=t(dt), occupancy=t(occ),
                    orig_x=t(origin[0]), orig_y=t(origin[1]),
                    orig_c=t(np.cos(origin[2])), orig_s=t(np.sin(origin[2])),
                    resolution=t(resolution),
                    height=t(h, torch.int32), width=t(w, torch.int32))
    return tmap if pad_to is None else pad_map(tmap, pad_to)


def pad_map(tmap: TrackMap, pad_to: tuple[int, int]) -> TrackMap:
    """A one-map TrackMap with dt and occupancy zero-padded at the far row
    and column ends to ``pad_to`` = (H, W), for stacking maps of different
    extents (JAX ``load_map(pad_to=...)``).  Zero is "at an obstacle", so a
    ray entering the padding stops; the true height/width stay, so the
    out-of-map test is unchanged.  Padding after the EDT leaves every cell
    of the map as it was.  Raises ValueError when ``pad_to`` is smaller
    than the map."""
    h, w = tmap.dt.shape
    ph, pw = pad_to
    if ph < h or pw < w:
        raise ValueError(f"pad_to {tuple(pad_to)} smaller than map {(h, w)}")
    pad = (0, pw - w, 0, ph - h)
    return tmap._replace(dt=torch.nn.functional.pad(tmap.dt, pad),
                         occupancy=torch.nn.functional.pad(tmap.occupancy, pad))


def stack_maps(maps: Sequence[TrackMap]) -> TrackMap:
    """Stack maps of one padded shape along a leading map axis (JAX
    ``stack_maps``): dt (M, H, W), every scalar (M,)."""
    return TrackMap(*[torch.stack([getattr(m, f) for m in maps])
                      for f in TrackMap._fields])
