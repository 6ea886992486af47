"""Classic map import: berlin / skirk / vegas / stata_basement (+ levine).

PyTorch-package counterpart of ``red_gym_tpu/maps/classic.py``.  The
reference ships its classic ROS-style maps inside the gym package
(reference: gym/f110_gym/envs/maps/*.yaml); this repo vendors only berlin
and skirk, converted.  This module makes the others usable:

* ``import_classic_maps(source, dest)`` converts a f1tenth_gym checkout's
  maps into the normalized package layout (8-bit grayscale PNG + rewritten
  minimal yaml, waypoint CSVs when present).
* ``classic_map_path(name)`` resolves a classic map: the packaged copy
  (berlin, skirk), then a converted copy ($RED_GYM_TPU_CLASSIC_MAPS, else
  the user cache), else converts on the fly from the checkout named by
  $F1TENTH_GYM_SOURCE.

Images are read and converted with no Pillow (``maps.loader.read_image``:
PNG of every colour type at depth 8, palette PNG at depth 1 to 8, binary
PGM) and converted to gray with Pillow's ``convert("L")`` integer formula;
the yaml is written with no PyYAML, in a form ``yaml.safe_load`` reads back
as the JAX package's dict.  Usage::

    python -m red_gym_tpu_torch.maps.classic --source f1tenth_gym/gym/f110_gym/envs/maps
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from red_gym_tpu_torch.assets import DATA_DIR
from red_gym_tpu_torch.maps.loader import encode_png, read_image, read_map_yaml

CLASSIC_MAPS = ("berlin", "skirk", "vegas", "levine", "stata_basement")


def _default_sources() -> tuple[str, ...]:
    src = os.environ.get("F1TENTH_GYM_SOURCE", "")
    return (src,) if src else ()


def _default_dest() -> str:
    return os.environ.get(
        "RED_GYM_TPU_CLASSIC_MAPS",
        os.path.join(os.path.expanduser("~"), ".cache", "red_gym_tpu",
                     "classic_maps"))


def to_gray(pixels: np.ndarray, mode: str, palette=None) -> np.ndarray:
    """Pillow's ``Image.convert("L")`` of a decoded image
    (``maps.loader.read_image``): "L" as is, "LA" its L channel, "RGB" and
    "RGBA" by ``(R * 19595 + G * 38470 + B * 7471 + 0x8000) >> 16`` (alpha
    dropped), "P" by that formula on the palette entry of each index."""
    if mode == "L":
        return pixels
    if mode == "LA":
        return pixels[..., 0]
    if mode == "P":
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(palette)] = palette
        pixels = pal[pixels]
    elif mode not in ("RGB", "RGBA"):
        raise ValueError(f"cannot convert image mode {mode!r} to gray")
    rgb = pixels[..., :3].astype(np.uint32)
    gray = (rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000) >> 16
    return gray.astype(np.uint8)


def _yaml_number(v: float) -> str:
    """A float as PyYAML's safe_dump writes it: repr, with a ``.0`` put in
    front of a bare exponent so that YAML reads it back as a float."""
    v = float(v)
    if v != v:
        return ".nan"
    if v in (float("inf"), float("-inf")):
        return ".inf" if v > 0 else "-.inf"
    text = repr(v).lower()
    if "." not in text and "e" in text:
        text = text.replace("e", ".0e", 1)
    return text


def write_map_yaml(path: str, meta: dict) -> None:
    """The converted map's yaml: the JAX package's ``yaml.safe_dump`` of
    the same dict (sorted keys, flow-style origin), written by hand."""
    lines = []
    for key in sorted(meta):
        v = meta[key]
        if isinstance(v, list):
            lines.append(f"{key}: [{', '.join(_yaml_number(x) for x in v)}]")
        elif isinstance(v, float):
            lines.append(f"{key}: {_yaml_number(v)}")
        else:
            lines.append(f"{key}: {v}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def import_classic_map(name: str, source_dir: str, dest_dir: str) -> str:
    """Convert one classic map to the package layout; returns the yaml path.

    The occupancy image is re-encoded as 8-bit grayscale PNG (the reference
    mixes png/pgm and palette images) and the yaml rewritten to the minimal
    field set the loader reads (resolution, origin, image,
    negate/thresholds), with the values the reference reads
    (laser_models.py:398-427: resolution + origin + >128 binarization)."""
    src_yaml = os.path.join(source_dir, f"{name}.yaml")
    if not os.path.isfile(src_yaml):
        raise FileNotFoundError(src_yaml)
    meta = read_map_yaml(src_yaml)

    img_name = meta.get("image", f"{name}.png")
    src_img = os.path.join(source_dir, img_name)
    if not os.path.isfile(src_img):
        # the reference strips some large blobs (levine.pgm): name the
        # missing binary
        raise FileNotFoundError(
            f"{src_img} (the source checkout does not carry this image; "
            f"the reference strips some, see .MISSING_LARGE_BLOBS)")

    os.makedirs(dest_dir, exist_ok=True)
    encode_png(os.path.join(dest_dir, f"{name}.png"), to_gray(*read_image(src_img)))

    out_yaml = os.path.join(dest_dir, f"{name}.yaml")
    write_map_yaml(out_yaml, {
        "image": f"{name}.png",
        "resolution": float(meta["resolution"]),
        "origin": [float(v) for v in meta["origin"]],
        "negate": int(meta.get("negate", 0)),
        "occupied_thresh": float(meta.get("occupied_thresh", 0.45)),
        "free_thresh": float(meta.get("free_thresh", 0.196)),
    })

    # waypoint csv rides along when the source has one
    for suffix in (".csv", "_waypoints.csv"):
        src_csv = os.path.join(source_dir, f"{name}{suffix}")
        if os.path.isfile(src_csv):
            with open(src_csv) as fin, open(
                    os.path.join(dest_dir, f"{name}{suffix}"), "w") as fout:
                fout.write(fin.read())
    return out_yaml


def import_classic_maps(source_dir: str, dest_dir: str | None = None,
                        names=CLASSIC_MAPS) -> dict:
    """Convert every available classic map; returns {name: yaml_path}.
    Maps whose binaries are missing in the source are skipped with a
    notice."""
    dest_dir = dest_dir or _default_dest()
    out = {}
    for name in names:
        try:
            out[name] = import_classic_map(name, source_dir, dest_dir)
        except FileNotFoundError as exc:
            print(f"skipping {name}: {exc}")
    return out


def classic_map_path(name: str) -> str:
    """Resolve (converting if needed) the yaml path of a classic map.

    Raises KeyError for a name not in CLASSIC_MAPS, and FileNotFoundError
    when neither a converted copy nor a source checkout is available."""
    if name not in CLASSIC_MAPS:
        raise KeyError(f"unknown classic map {name!r}; have {CLASSIC_MAPS}")
    # berlin and skirk ship converted with the repository
    packaged = os.path.join(DATA_DIR, "classic", f"{name}.yaml")
    if os.path.isfile(packaged):
        return packaged
    dest = _default_dest()
    ready = os.path.join(dest, f"{name}.yaml")
    if os.path.isfile(ready):
        return ready
    for source in _default_sources():
        if os.path.isfile(os.path.join(source, f"{name}.yaml")):
            return import_classic_map(name, source, dest)
    raise FileNotFoundError(
        f"classic map {name!r}: no converted copy under {dest} and no "
        f"source checkout found: clone f1tenth_gym and run python -m "
        f"red_gym_tpu_torch.maps.classic --source <maps dir>, or set "
        f"F1TENTH_GYM_SOURCE to that maps dir")


def main(argv=None):
    ap = argparse.ArgumentParser(description="Convert the classic f1tenth_gym maps "
                                 "into the package layout.")
    ap.add_argument("--source", required=True,
                    help="maps dir of a f1tenth_gym/reference checkout")
    ap.add_argument("--dest", default=None,
                    help=f"output dir (default {_default_dest()})")
    args = ap.parse_args(argv)
    done = import_classic_maps(args.source, args.dest)
    for name, path in done.items():
        print(f"{name}: {path}")


if __name__ == "__main__":
    main()
