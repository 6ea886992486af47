"""Track map loading: ROS-style yaml + PNG or PGM -> EDT -> TrackMap tensors.

PyTorch counterpart of ``red_gym_tpu/maps/loader.py``.  The map's distance
transform is computed once on the host in float64 with scipy (the fallback
the JAX package uses, ``red_gym_tpu/native/__init__.py``) and moved to the
device, or with ``edt_backend="device"`` on the device (``ops/edt.py``).
The yaml and the image (PNG of every colour type at depth 8 and palette
PNG at depth 1 to 8, binary PGM) are parsed here with the standard library,
so the package needs neither PyYAML nor Pillow; :func:`encode_png` writes
the grayscale PNGs of ``maps/trackgen.py`` and ``maps/classic.py``.
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
from red_gym_tpu_torch.utils.profiling import setup_span


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


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> (PIL mode of the decoded image, channels, bit depths read)
_PNG_TYPES = {0: ("L", 1, (8,)), 2: ("RGB", 3, (8,)), 3: ("P", 1, (1, 2, 4, 8)),
              4: ("LA", 2, (8,)), 6: ("RGBA", 4, (8,))}


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int, path: str):
    """Undo the PNG scanline filters: raw (height, 1 + stride) -> (height,
    stride) uint8.  ``bpp`` is the filters' byte distance to the left
    neighbour (bytes a pixel, at least 1)."""
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for r in range(height):
        kind, line = raw[r, 0], raw[r, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:     # Sub: running sum along the row, per byte lane
            lanes = line.reshape(-1, bpp).astype(np.uint64)
            cur = (lanes.cumsum(axis=0) % 256).astype(np.uint8).reshape(-1)
        elif kind == 2:     # Up
            cur = line + prior
        elif kind in (3, 4):  # Average / Paeth: sequential along the row
            vals, up = line.tolist(), prior.tolist()
            cur_l = [0] * stride
            for i in range(stride):
                a = cur_l[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    pred = (a + b) // 2
                else:
                    pred = _paeth(a, b, up[i - bpp] if i >= bpp else 0)
                cur_l[i] = (vals[i] + pred) & 0xFF
            cur = np.array(cur_l, np.uint8)
        else:
            raise ValueError(f"{path}: bad PNG filter type {kind} in row {r}")
        out[r] = cur
        prior = cur
    return out


def read_png(path: str):
    """Decode a non-interlaced PNG of colour type 0 (gray), 2 (RGB), 4 (gray
    + alpha) or 6 (RGBA) at bit depth 8, or 3 (palette) at depth 1, 2, 4 or
    8 -> (pixels, mode, palette): pixels uint8 (H, W) for "L" and the
    palette indices of "P", (H, W, C) for "LA", "RGB" and "RGBA", rows top
    to bottom (PIL's ``np.array(Image.open(path))``); palette (N, 3) uint8
    for "P", else None.  Anything else raises ValueError."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr, palette = 8, [], None, None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    width, height, depth, color, _, _, interlace = hdr
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNGs are not supported; "
                         f"save the image without interlacing")
    if color not in _PNG_TYPES or depth not in _PNG_TYPES[color][2]:
        raise ValueError(f"{path}: unsupported PNG: colour type {color} at bit "
                         f"depth {depth} (supported: gray, RGB, gray + alpha and "
                         f"RGBA at depth 8; palette at depth 1, 2, 4 or 8)")
    mode, chans, _ = _PNG_TYPES[color]
    if mode == "P" and palette is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    stride = (width * chans * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[:height * (stride + 1)].reshape(height, stride + 1)
    rows = _unfilter(raw, height, stride, max(1, chans * depth // 8), path)
    if depth < 8:    # palette indices packed several to a byte, high bits first
        per = 8 // depth
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        rows = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(
            height, stride * per)
    pixels = rows[:, :width * chans]
    if chans > 1:
        pixels = pixels.reshape(height, width, chans)
    return np.ascontiguousarray(pixels), mode, palette


def decode_png(path: str) -> np.ndarray:
    """The pixels of :func:`read_png`: uint8 (H, W) or (H, W, C), rows top
    to bottom."""
    return read_png(path)[0]


def decode_pgm(path: str) -> np.ndarray:
    """Decode a binary PGM (P5) with maxval 255 -> uint8 (H, W), rows top
    to bottom."""
    with open(path, "rb") as f:
        data = f.read()
    tokens, pos = [], 0
    while len(tokens) < 4:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        tokens.append(data[start:pos])
    if tokens[0] != b"P5":
        raise ValueError(f"{path}: not a binary PGM (P5) file")
    width, height, maxval = (int(t) for t in tokens[1:])
    if maxval != 255:
        raise ValueError(f"{path}: PGM maxval {maxval}; only 255 is supported")
    pos += 1   # the one whitespace byte after maxval
    return np.frombuffer(data[pos:pos + width * height], np.uint8).reshape(height, width).copy()


def read_image(path: str):
    """(pixels, mode, palette) of a PNG (:func:`read_png`) or a binary
    PGM (mode "L"), by the file's signature."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head == _PNG_SIGNATURE:
        return read_png(path)
    if head[:2] == b"P5":
        return decode_pgm(path), "L", None
    raise ValueError(f"{path}: neither a PNG nor a binary PGM (P5) image")


def encode_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W) uint8 array as an 8-bit grayscale PNG (rows top to
    bottom, no filtering)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 2:
        raise ValueError(f"encode_png writes one gray (H, W) image, got {img.shape}")
    h, w = img.shape

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), img], axis=1)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 9)) + chunk(b"IEND", b""))


def load_map_image(image_path: str) -> np.ndarray:
    """Image -> binarized float64 occupancy grid, reference pipeline
    (laser_models.py:398-404): flip top-bottom, threshold at 128.  As in the
    JAX package, an RGB(A) or gray + alpha image gives its channel 0 and a
    palette image its indices."""
    img = read_image(image_path)[0][::-1].astype(np.float64)
    if img.ndim == 3:
        img = img[..., 0]
    return np.where(img <= 128.0, 0.0, 255.0)


@setup_span("setup/map_load")
def load_map(map_yaml_path: str, map_ext: str = ".png",
             dtype=torch.float32, device="cuda",
             pad_to: tuple[int, int] | None = None,
             edt_backend: str = "host") -> TrackMap:
    """Load yaml + image, compute the EDT, return a TrackMap with its
    tensors on ``device`` (the card unless the caller passes "cpu").
    ``pad_to`` = (H, W) pads the map after the EDT (:func:`pad_map`).

    ``edt_backend``: "host" (default; scipy in float64) or "device" (the
    exact float32 EDT of ``ops/edt.py`` on ``device``: kernel E on the
    card, its twin on the CPU), whose result is cast to ``dtype`` after
    the EDT and before the padding, as in JAX."""
    device = resolve_device(device)
    if edt_backend not in ("host", "device"):
        raise ValueError(f"edt_backend must be 'host' or 'device', got {edt_backend!r}")
    meta = read_map_yaml(map_yaml_path)
    resolution = float(meta["resolution"])
    origin = meta["origin"]
    occ = load_map_image(os.path.splitext(map_yaml_path)[0] + map_ext)
    h, w = occ.shape
    with setup_span("setup/edt"):
        if edt_backend == "device":
            from red_gym_tpu_torch.ops.edt import edt

            dt = edt(torch.as_tensor(occ, device=device), resolution)
        else:
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
