"""The port's map loading and range-texture build against the JAX package.

The texture is built by both packages in float64 on track_0019 at texture
stride 8.  Bars: ``valid`` exactly equal; at least 99.9 % of ``rt`` entries
within 1e-9, the rest (edge-bisection flips, where a last-bit difference in
a march sends the bisection the other way) counted and bounded by that
0.1 %.  The map loader's own PNG/yaml parsers are held against Pillow and
PyYAML, which the JAX package uses.
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from red_gym_tpu.config import SimConfig as JSimConfig
from red_gym_tpu.maps.loader import load_map as jload_map
from red_gym_tpu.ops import scan as jscan, scan_fast as jsf
from red_gym_tpu_torch import assets
from red_gym_tpu_torch.config import SimConfig as TSimConfig
from red_gym_tpu_torch.maps import loader as tloader
from red_gym_tpu_torch.ops import scan as tscan, scan_fast as tsf

TRACK = "track_0019"
CFG_KW = dict(num_agents=2, num_beams=270, dtype="float64", scan_mode="fast",
              rt_pose_stride=8)
PNGS = sorted(glob.glob(os.path.join(assets.DATA_DIR, "**", "*.png"), recursive=True))
TRACKS = sorted(os.path.basename(p)[:-len("_waypoints.csv")]
                for p in glob.glob(os.path.join(assets.DATA_DIR, "*_waypoints.csv")))


@pytest.fixture(scope="module")
def textures():
    torch.set_num_threads(2)
    yaml_path = assets.named_map_yaml(TRACK)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RED_GYM_TPU_TEXTURE_CACHE", "off")
        jm = jload_map(yaml_path, ".png", dtype=jnp.float64)
        jr = jsf.build_range_texture(jm, JSimConfig(**CFG_KW))
        tm = tloader.load_map(yaml_path, dtype=torch.float64)
        tr = tsf.build_range_texture(tm, TSimConfig(**CFG_KW))
    return jm, jr, tm, tr


def test_load_map_matches(textures):
    jm, _, tm, _ = textures
    for f in jm._fields:
        np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                      np.asarray(getattr(jm, f)), err_msg=f)


def test_texture_valid_exact_and_rt_close(textures):
    _, jr, _, tr = textures
    np.testing.assert_array_equal(tr.valid.numpy(), np.asarray(jr.valid))
    assert tr.rt.shape == jr.rt.shape and tr.rt.dtype == torch.float64
    err = np.abs(tr.rt.numpy() - np.asarray(jr.rt))
    flips = int((err > 1e-9).sum())
    assert flips <= 1e-3 * err.size, f"{flips} of {err.size} entries differ"
    assert (tr.rt.numpy()[:, :128][tr.valid.numpy()] >= 1e-3).all()
    for f in ("hc", "wc", "cell", "fmat", "gmat", "smat"):
        np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                      np.asarray(getattr(jr, f)), err_msg=f)


def test_step_constants_match_jax_per_call_forms(textures):
    """fmat_sw, shift1 and c_frac, which the JAX package forms on every call
    (scan_fast.py:950-953), are computed once by the port."""
    _, jr, _, tr = textures
    t_bins = 128
    np.testing.assert_array_equal(
        tr.fmat_sw.numpy(), np.asarray(jnp.roll(jr.fmat, -(t_bins // 2), axis=1)))
    np.testing.assert_array_equal(
        tr.shift1.numpy(),
        np.asarray(jnp.roll(jnp.eye(t_bins, dtype=jnp.float64), -1, axis=1)))
    angles = tscan.build_tables(TSimConfig(**CFG_KW), 0.31, 0.58).scan_angles
    c_frac = jnp.mod(jnp.asarray(angles.numpy()) * (t_bins / (2 * np.pi)), 1.0)
    np.testing.assert_array_equal(tr.c_frac.numpy(), np.asarray(c_frac))


def test_texture_disk_cache(tmp_path, monkeypatch, textures):
    _, _, tm, tr = textures
    monkeypatch.setenv("RED_GYM_TPU_TEXTURE_CACHE", str(tmp_path))
    cfg = TSimConfig(**CFG_KW)
    path = tsf._texture_cache_path(tm, cfg)
    assert os.path.basename(path).startswith("rtex_torch_")
    first = tsf.build_range_texture(tm, cfg)
    assert os.path.exists(path)
    second = tsf.build_range_texture(tm, cfg)
    assert torch.equal(first.rt, tr.rt) and torch.equal(second.rt, tr.rt)
    assert torch.equal(second.valid, tr.valid)
    # the JAX package's file for the same map and settings is never read
    jm = jload_map(assets.named_map_yaml(TRACK), ".png", dtype=jnp.float64)
    assert jsf._texture_cache_path(jm, JSimConfig(**CFG_KW)) != path


@pytest.mark.parametrize("png", PNGS, ids=os.path.basename)
def test_png_decoder_matches_pillow(png):
    np.testing.assert_array_equal(tloader.decode_png(png), np.array(Image.open(png)))


def test_map_yaml_parser_matches_pyyaml():
    for path in glob.glob(os.path.join(assets.DATA_DIR, "**", "*.yaml"), recursive=True):
        with open(path) as f:
            ref = yaml.safe_load(f)
        got = tloader.read_map_yaml(path)
        assert set(got) == set(ref), path
        for k, v in ref.items():
            assert got[k] == (v if not isinstance(v, int) else float(v)), (path, k)


@pytest.mark.parametrize("track", TRACKS)
def test_waypoint_start_poses_are_in_free_space(track):
    tm = tloader.load_map(assets.named_map_yaml(track), dtype=torch.float64)
    poses = torch.from_numpy(assets.waypoint_start_poses(track, 2))
    clearance = tscan.dt_lookup(poses[:, 0], poses[:, 1], tm)
    assert (clearance > 0.3).all(), clearance


def test_dt_lookup_matches_including_out_of_bounds(textures):
    """Points outside the map read dt[h-1, w-1], the reference's quirk."""
    jm, _, tm, _ = textures
    rng = np.random.default_rng(4)
    x = rng.uniform(-40.0, 40.0, 20000)
    y = rng.uniform(-40.0, 40.0, 20000)
    j = np.asarray(jscan.dt_lookup(jnp.asarray(x), jnp.asarray(y), jm))
    t = tscan.dt_lookup(torch.from_numpy(x), torch.from_numpy(y), tm).numpy()
    np.testing.assert_array_equal(t, j)
    corner = float(tm.dt[-1, -1])
    outside = (x < float(tm.orig_x)) | (y < float(tm.orig_y))
    assert outside.any() and (t[outside] == corner).all()


@pytest.mark.parametrize("march_iters", [0, 40])
def test_march_matches_jax(textures, march_iters):
    """Rays from free cells at random angles: the port's march (compacting
    the running rays, or a fixed budget) against the JAX while/fori loop."""
    jm, _, tm, _ = textures
    rng = np.random.default_rng(5)
    cand = np.argwhere(np.asarray(jm.dt) > 0.2)
    free = cand[rng.integers(0, len(cand), 4000)]
    res = float(tm.resolution)
    x = (free[:, 1] + 0.5) * res + float(tm.orig_x)
    y = (free[:, 0] + 0.5) * res + float(tm.orig_y)
    ang = rng.uniform(0, 2 * np.pi, x.size)
    rays = (x, y, np.cos(ang), np.sin(ang))
    jc = JSimConfig(**CFG_KW, march_iters=march_iters)
    tc = TSimConfig(**CFG_KW, march_iters=march_iters)
    j = np.asarray(jscan.march(*map(jnp.asarray, rays), jm, jc))
    t = tscan.march(*map(torch.from_numpy, rays), tm, tc).numpy()
    assert np.mean(np.abs(t - j) <= 1e-9) >= 0.999
    assert (t > 0).all() and (t <= 30.0).all()
