"""The port's map images against the JAX package's loader and Pillow.

``maps.loader.load_map_image`` reads every image the JAX package reads
(Pillow there, the standard library here): PNG of colour types 0, 2, 3, 4
and 6 at bit depth 8, palette PNG at depths 1, 2, 4 and 8, and binary PGM;
an RGB(A) or gray + alpha image gives its channel 0 and a palette image its
indices.  Pillow writes each image in the test; the occupancy grids must be
EQUAL to JAX's ``load_map_image`` (exact: both are 0/255 float64).  The
port's PNG encoder, read back by Pillow, must be pixel-equal.
"""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from red_gym_tpu.maps.loader import load_map_image as jax_load_map_image
from red_gym_tpu_torch.maps import loader

H, W = 37, 53


def _pixels(seed=0):
    return np.random.default_rng(seed).integers(0, 256, (H, W, 4), dtype=np.uint8)


def _image(mode: str):
    a = _pixels()
    if mode == "L":
        return Image.fromarray(a[..., 0]), {}
    if mode == "LA":
        return Image.fromarray(a[..., 0]).convert("LA"), {}
    if mode == "RGB":
        return Image.fromarray(a[..., :3]), {}
    if mode == "RGBA":
        return Image.fromarray(a), {}
    if mode == "P":
        return Image.fromarray(a[..., :3]).convert("P", palette=Image.ADAPTIVE,
                                                    colors=200), {}
    bits = int(mode[1:])                      # "P1", "P2", "P4": packed indices
    im = Image.fromarray((a[..., 0] % (1 << bits)).astype(np.uint8), "L").convert("P")
    im.putpalette(list(range(256)) * 3)
    return im, {"bits": bits}


MODES = ["L", "LA", "RGB", "RGBA", "P", "P1", "P2", "P4"]


@pytest.mark.parametrize("mode", MODES)
def test_png_modes_load_equal_to_jax(mode, tmp_path):
    im, kw = _image(mode)
    path = str(tmp_path / f"{mode}.png")
    im.save(path, **kw)
    pixels, got_mode, _ = loader.read_image(path)
    np.testing.assert_array_equal(pixels, np.array(Image.open(path)))
    assert got_mode == Image.open(path).mode
    np.testing.assert_array_equal(loader.load_map_image(path), jax_load_map_image(path))


def test_pgm_loads_equal_to_jax(tmp_path):
    path = str(tmp_path / "map.pgm")
    Image.fromarray(_pixels()[..., 1]).save(path)
    np.testing.assert_array_equal(loader.read_image(path)[0], np.array(Image.open(path)))
    np.testing.assert_array_equal(loader.load_map_image(path), jax_load_map_image(path))


def test_png_filters_of_every_kind_decode(tmp_path):
    """Pillow's adaptive filtering on a smooth RGB image uses the Sub, Up,
    Average and Paeth filters with 3-byte pixels."""
    y, x = np.mgrid[0:H, 0:W]
    a = np.stack([(x * 5) % 256, (y * 7) % 256, (x * y) % 256], -1).astype(np.uint8)
    path = str(tmp_path / "smooth.png")
    Image.fromarray(a).save(path, optimize=True)
    np.testing.assert_array_equal(loader.read_image(path)[0], a)


def test_encoder_reads_back_pixel_equal(tmp_path):
    a = _pixels(3)[..., 2]
    path = str(tmp_path / "enc.png")
    loader.encode_png(path, a)
    im = Image.open(path)
    assert im.mode == "L"
    np.testing.assert_array_equal(np.array(im), a)
    np.testing.assert_array_equal(loader.decode_png(path), a)


@pytest.mark.parametrize("kind", ["interlaced", "16-bit", "pgm maxval"])
def test_unsupported_images_raise_clearly(kind, tmp_path):
    if kind == "interlaced":
        # Pillow writes no interlaced PNG: set the IHDR's interlace byte
        path = str(tmp_path / "i.png")
        Image.fromarray(_pixels()[..., 0]).save(path)
        data = bytearray(open(path, "rb").read())
        data[28] = 1                                  # 8 + 8 + 12: interlace method
        data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])) & 0xFFFFFFFF)
        open(path, "wb").write(bytes(data))
        assert Image.open(path).info.get("interlace") == 1
        match = "interlaced"
    elif kind == "16-bit":
        path = str(tmp_path / "w.png")
        Image.fromarray(_pixels()[..., 0].astype(np.uint16) * 200).save(path)
        match = "bit depth 16"
    else:
        path = str(tmp_path / "m.pgm")
        with open(path, "wb") as f:
            f.write(b"P5\n# c\n2 2\n1023\n" + bytes(8))
        match = "maxval 1023"
    with pytest.raises(ValueError, match=match):
        loader.read_image(path)
