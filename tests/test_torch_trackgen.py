"""The port's track generator against the JAX package's.

The geometry is the same numpy code: ``generate_centerline`` and
``speed_profile`` BIT-equal, the waypoint CSV byte-equal, and the yaml
equal, for seeds 0, 19 and 123.  The corridor image is drawn without
OpenCV (``trackgen.thick_closed_polyline``, OpenCV's ThickLine in integer
arithmetic) and must equal JAX's ``cv2.polylines`` image pixel for pixel on
these tracks.  Then JAX's test_pure_pursuit_laps_generated_track on a
port-generated track: the exact scan in float64, pure pursuit at tlad 1.0,
vgain 0.75, two laps with no collision before done.
"""

import filecmp
import os

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from red_gym_tpu.maps import trackgen as jax_trackgen
from red_gym_tpu_torch import env as tenv
from red_gym_tpu_torch.agents import pure_pursuit as pp
from red_gym_tpu_torch.config import SimConfig
from red_gym_tpu_torch.maps import loader, trackgen

SEEDS = [0, 19, 123]


@pytest.mark.parametrize("seed", SEEDS)
def test_centerline_and_speeds_bit_equal(seed):
    c = trackgen.generate_centerline(seed)
    np.testing.assert_array_equal(c, jax_trackgen.generate_centerline(seed))
    np.testing.assert_array_equal(trackgen.speed_profile(c), jax_trackgen.speed_profile(c))
    np.testing.assert_array_equal(trackgen._normals(c), jax_trackgen._normals(c))
    c7 = trackgen.generate_centerline(seed, n_checkpoints=7, n_points=300)
    np.testing.assert_array_equal(
        c7, jax_trackgen.generate_centerline(seed, n_checkpoints=7, n_points=300))


@pytest.mark.parametrize("seed", SEEDS)
def test_generated_files_equal_jax(seed, tmp_path):
    """yaml and CSV byte-equal; the PNG pixel-equal to JAX's cv2 corridor."""
    t_yaml = trackgen.generate(str(tmp_path / "t"), seed=seed)
    j_yaml = jax_trackgen.generate(str(tmp_path / "j"), seed=seed)
    assert os.path.basename(t_yaml) == os.path.basename(j_yaml)
    assert filecmp.cmp(t_yaml, j_yaml, shallow=False)
    assert filecmp.cmp(t_yaml.replace(".yaml", "_waypoints.csv"),
                       j_yaml.replace(".yaml", "_waypoints.csv"), shallow=False)
    png = t_yaml.replace(".yaml", ".png")
    got = np.array(Image.open(png))
    want = np.array(Image.open(j_yaml.replace(".yaml", ".png")))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(loader.decode_png(png), want)


@pytest.mark.parametrize("thickness", [2, 3, 83, 84])
def test_thick_polyline_equals_cv2_on_a_track(thickness):
    center = trackgen.generate_centerline(5, n_points=200)
    pts = np.rint((center - center.min(0) + 8.0) / 0.0625).astype(np.int32)
    h, w = pts[:, 1].max() + 200, pts[:, 0].max() + 200
    got = np.zeros((h, w), np.uint8)
    trackgen.thick_closed_polyline(got, pts, thickness)
    want = np.zeros((h, w), np.uint8)
    cv2.polylines(want, [pts.reshape(-1, 1, 2)], isClosed=True, color=255,
                  thickness=thickness, lineType=cv2.LINE_8)
    np.testing.assert_array_equal(got, want)


def test_cli_writes_a_loadable_track(tmp_path, capsys):
    trackgen.main(["--seed", "4", "--n", "2", "--outdir", str(tmp_path)])
    out = capsys.readouterr().out.split()
    assert out == ["wrote", str(tmp_path / "track_0004.yaml"),
                   "wrote", str(tmp_path / "track_0005.yaml")]
    tmap = loader.load_map(str(tmp_path / "track_0005.yaml"), dtype=torch.float64,
                           device="cpu")
    frac_free = float((tmap.occupancy == 255).double().mean())
    assert 0.03 < frac_free < 0.6


def test_pure_pursuit_laps_generated_track(tmp_path):
    """End-to-end: the planner completes two laps on a freshly generated
    map, with no collision up to and including the finish (the loop stops
    at done, where JAX's scan runs on)."""
    torch.set_num_threads(1)     # one env: small ops, threads only add overhead
    yaml_path = trackgen.generate(str(tmp_path), seed=3)
    cfg = SimConfig(num_agents=1, num_beams=108, timestep=0.01, dtype="float64")
    params = tenv.make_params(cfg, yaml_path, ".png", device="cpu")
    wpts = pp.load_waypoints_csv(yaml_path.replace(".yaml", "_waypoints.csv"),
                                 dtype=torch.float64, device="cpu")
    ppp = pp.make_params(wpts, tlad=1.0, vgain=0.75)
    start = torch.tensor([[[wpts[0, 0], wpts[0, 1],
                            torch.atan2(wpts[1, 1] - wpts[0, 1], wpts[1, 0] - wpts[0, 0])]]],
                         dtype=torch.float64)
    gen = torch.Generator().manual_seed(0)
    state, obs, *_ = tenv.reset(cfg, params, start, gen)
    done = torch.zeros(1, dtype=torch.bool)
    for _ in range(12000):
        speed, steer = pp.plan(obs.poses_x[0, 0], obs.poses_y[0, 0],
                               obs.poses_theta[0, 0], ppp)
        state, obs, _, done, _ = tenv.step(
            cfg, params, state, torch.stack([steer, speed])[None, None], gen)
        assert float(obs.collisions[0, 0]) == 0.0, "crashed on generated track"
        if bool(done[0]):
            break
    assert bool(done[0]), "never completed two laps on generated track"
