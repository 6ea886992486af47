"""The port's classic-map import against the JAX package's.

A source directory is made in tmp_path from the vendored berlin and skirk
(8-bit gray PNG) and from Pillow-written copies of berlin's image as RGB
PNG (vegas), RGBA PNG (stata_basement) and palette PNG and binary PGM
(levine: its yaml names a .pgm, as the reference's does).  Both packages
convert it; every converted image must be PIXEL-equal and every yaml equal
as a ``yaml.safe_load`` dict.
"""

import os
import shutil

import numpy as np
import pytest
import yaml
from PIL import Image

from red_gym_tpu.maps import classic as jax_classic
from red_gym_tpu_torch import assets
from red_gym_tpu_torch.maps import classic, loader

CLASSIC = os.path.join(assets.DATA_DIR, "classic")


def _yaml(name, image, origin="[-11.60654, -26.520793, 0.0]", extra=""):
    return (f"image: {image}\nresolution: 0.05\norigin: {origin}\n"
            f"negate: 0\n{extra}")


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    src = tmp_path_factory.mktemp("classic_src")
    for n in ("berlin", "skirk"):
        for ext in ("yaml", "png"):
            shutil.copy(os.path.join(CLASSIC, f"{n}.{ext}"), src)
    gray = np.array(Image.open(os.path.join(CLASSIC, "berlin.png")))
    rng = np.random.default_rng(0)
    rgb = np.stack([gray, np.roll(gray, 3, 0), rng.integers(0, 256, gray.shape)], -1)
    rgb = rgb.astype(np.uint8)
    Image.fromarray(rgb).save(src / "vegas.png")
    (src / "vegas.yaml").write_text(_yaml("vegas", "vegas.png", "[-1.5, 2.25e-5, 0.1]",
                                          "occupied_thresh: 0.65\nfree_thresh: 0.196\n"))
    rgba = np.concatenate([rgb, rng.integers(0, 256, gray.shape + (1,)).astype(np.uint8)], -1)
    Image.fromarray(rgba).save(src / "stata_basement.png")
    (src / "stata_basement.yaml").write_text(_yaml("stata_basement", "stata_basement.png",
                                                   "[1, 2, 3]"))
    Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE).save(src / "levine_p.png")
    Image.fromarray(gray).save(src / "levine.pgm")
    (src / "levine.yaml").write_text(_yaml("levine", "levine.pgm"))
    (src / "berlin_waypoints.csv").write_text("# s;x;y\n0;1;2\n")
    return str(src)


@pytest.fixture(scope="module")
def converted(source, tmp_path_factory):
    dest = tmp_path_factory.mktemp("converted")
    return (classic.import_classic_maps(source, str(dest / "t")),
            jax_classic.import_classic_maps(source, str(dest / "j")))


def test_every_map_converts_pixel_equal(converted):
    ours, theirs = converted
    assert set(ours) == set(theirs) == set(classic.CLASSIC_MAPS)
    for name in ours:
        got = np.array(Image.open(ours[name][:-5] + ".png"))
        want = np.array(Image.open(theirs[name][:-5] + ".png"))
        assert Image.open(ours[name][:-5] + ".png").mode == "L"
        np.testing.assert_array_equal(got, want, err_msg=name)
        with open(ours[name]) as f, open(theirs[name]) as g:
            assert yaml.safe_load(f) == yaml.safe_load(g), name
    assert os.path.isfile(os.path.join(os.path.dirname(ours["berlin"]), "berlin_waypoints.csv"))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "P", "LA"])
def test_to_gray_matches_pillow_convert(mode, tmp_path):
    rng = np.random.default_rng(1)
    im = Image.fromarray(rng.integers(0, 256, (21, 34, 4), dtype=np.uint8))
    im = {"RGB": im.convert("RGB"), "RGBA": im, "LA": im.convert("LA"),
          "P": im.convert("RGB").convert("P", palette=Image.ADAPTIVE)}[mode]
    path = str(tmp_path / f"{mode}.png")
    im.save(path)
    np.testing.assert_array_equal(classic.to_gray(*loader.read_image(path)),
                                  np.array(Image.open(path).convert("L")))


def test_missing_image_is_skipped_with_a_notice(source, tmp_path, capsys):
    src = tmp_path / "src"
    shutil.copytree(source, src)
    os.remove(src / "levine.pgm")
    done = classic.import_classic_maps(str(src), str(tmp_path / "out"))
    assert "levine" not in done and "berlin" in done
    out = capsys.readouterr().out
    assert "skipping levine" in out and "levine.pgm" in out


def test_classic_map_path_resolves(source, tmp_path, monkeypatch):
    """The packaged copy first, then the converted copy under
    $RED_GYM_TPU_CLASSIC_MAPS (made from $F1TENTH_GYM_SOURCE on the first
    call, found on the second), KeyError for an unknown name, and
    FileNotFoundError without a source."""
    monkeypatch.setenv("RED_GYM_TPU_CLASSIC_MAPS", str(tmp_path / "cache"))
    monkeypatch.setenv("F1TENTH_GYM_SOURCE", source)
    assert classic.classic_map_path("berlin") == os.path.join(CLASSIC, "berlin.yaml")
    path = classic.classic_map_path("vegas")           # converts from the source
    assert path == str(tmp_path / "cache" / "vegas.yaml") and os.path.isfile(path)
    monkeypatch.delenv("F1TENTH_GYM_SOURCE")
    assert classic.classic_map_path("vegas") == path   # second call: the cached copy
    with pytest.raises(KeyError):
        classic.classic_map_path("monaco")
    with pytest.raises(FileNotFoundError, match="stata_basement"):
        classic.classic_map_path("stata_basement")


def test_converted_map_loads(converted):
    tmap = loader.load_map(converted[0]["vegas"], device="cpu")
    assert int(tmap.height) == 600 and int(tmap.width) == 600
    assert abs(float(tmap.orig_y) - 2.25e-5) < 1e-12


def test_cli(source, tmp_path, capsys):
    classic.main(["--source", source, "--dest", str(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == f"berlin: {tmp_path / 'berlin.yaml'}"
    assert len(lines) == len(classic.CLASSIC_MAPS)
