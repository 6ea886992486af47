"""The last five examples' command lines on the CPU at smoke sizes, against
the JAX package where they compute something it computes.

- ``profile_components``: every phase under the JAX script's name.
- ``scan_error_study``: the float64 oracle equal to JAX's exact march on
  the same poses (within 1e-12 m: the same arithmetic), and each row's
  error statistics within 0.02 m (median, p90, p99) and 0.005 (the shares
  of beams off by more than 1 and 4 cells) of the rows JAX's
  ``trace_fast_mxu`` gives on a JAX-built texture at the same stride.  The
  two fast scans differ at the float32 bar (p99 |diff| < 1e-3 m, < 0.2 %
  of beams off by more than 4 cells), so their statistics against one
  oracle differ by about that much; the max is not compared (one beam).
- ``generalization_study``: 11 rows with the columns of JAX's committed
  CSV, the sorted packaged tracks, the last two held out.
- ``mpc_demo``: the controls against JAX's ``mpc_controller`` on the same
  path within 1e-5 (the float32 bar of tests/test_torch_mpc.py), the
  tracking error the JAX script's formula; the plots without matplotlib
  stop with a SystemExit.
- ``lidar_bitmap_example``: every frame pixel-equal to JAX's
  ``lidar_to_bitmap`` of the same scan, and the PNGs decode to the frames.
"""

import csv
import dataclasses
import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from red_gym_tpu.agents import mpc as jmpc
from red_gym_tpu.config import SimConfig as JSimConfig
from red_gym_tpu.maps.loader import load_map as jload_map
from red_gym_tpu.ops import scan as jscan, scan_fast as jsf
from red_gym_tpu.ops.rasterize import lidar_to_bitmap as jbitmap
from red_gym_tpu_torch import assets
from red_gym_tpu_torch.examples import (generalization_study, lidar_bitmap_example,
                                        mpc_demo, profile_components, scan_error_study)
from red_gym_tpu_torch.maps.loader import read_png

JAX_PHASES = ["noop (dispatch floor)", "dynamics RK4 (ST)", "scan exact (march 64)",
              "scan fast (element gather)", "scan fast (mxu)", "collision SAT (pairwise)",
              "iTTC check", "opponent raycast", "FULL step (fast scan)",
              "FULL step (exact scan)"]
FLOAT = r"-?\d+\.\d+"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def test_profile_components_times_the_jax_phases(capsys):
    ms = profile_components.main(["8", "--reps", "1", "--exact-reps", "1", "--beams",
                                  "108", "--rt-stride", "16", "--device", "cpu"])
    assert list(ms) == JAX_PHASES
    assert all(np.isfinite(v) and v > 0 for v in ms.values())
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    timed = lines[-len(JAX_PHASES):]
    for name, line in zip(JAX_PHASES, timed):
        assert re.fullmatch(rf"{re.escape(name)} +{FLOAT} ms/call +{FLOAT} M env/s",
                            line), line
    assert lines[-len(JAX_PHASES) - 1].startswith("backend=cpu  envs=8  agents=2")


def test_scan_error_study_rows_match_jax(capsys):
    stride, n = 8, 8
    rows, poses, exact = scan_error_study.main(
        ["--device", "cpu", "--rt-stride", str(stride), "--poses", str(n)])
    printed = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert len(rows) == len(printed) == 14
    # the oracle: JAX's exact float64 march on the same poses
    y = assets.named_map_yaml("track_wide")
    base = JSimConfig(num_agents=1, num_beams=1080, dtype="float32", scan_mode="fast",
                      rt_pose_stride=stride)
    cfg64 = dataclasses.replace(base, dtype="float64", rt_occlusion="off", rt_grad=False)
    tmap64 = jload_map(y, ".png", dtype=jnp.float64)
    tab64 = jscan.build_tables(cfg64, 0.31, 0.58, dtype=jnp.float64)
    j_exact = np.asarray(jscan.trace(jnp.asarray(poses), tab64, tmap64, cfg64))
    assert exact.shape == (n, 1080)
    np.testing.assert_allclose(exact, j_exact, rtol=0, atol=1e-12)
    # the rows: JAX's fast scans on its own texture at the same stride
    tmap32 = jload_map(y, ".png", dtype=jnp.float32)
    tab32 = jscan.build_tables(base, 0.31, 0.58, dtype=jnp.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RED_GYM_TPU_TEXTURE_CACHE", "off")
        full = jsf.build_range_texture(
            tmap32, dataclasses.replace(base, rt_occlusion="edge", rt_grad=True))
    t_bins = base.rt_theta_bins
    cell = float(full.cell)
    for row in rows:
        c = dataclasses.replace(base, rt_occlusion=row["occ"], rt_grad=row["grad"],
                                rt_spatial=row["spatial"], scan_interp=row["interp"])
        cols = [slice(0, t_bins)]
        if c.rt_eff_occlusion == "edge":
            cols.append(slice(t_bins, 3 * t_bins))
        if row["grad"]:
            cols.append(slice(3 * t_bins, 5 * t_bins))
        rtex = full._replace(rt=jnp.concatenate([full.rt[:, s] for s in cols], axis=1))
        fast = np.asarray(jsf.trace_fast_mxu(jnp.asarray(poses, jnp.float32), tab32,
                                             tmap32, rtex, c))
        want = scan_error_study.error_row(j_exact, fast, cell, occ=row["occ"],
                                          grad=row["grad"], spatial=row["spatial"],
                                          interp=row["interp"])
        assert list(row) == list(want)
        for k in ("median", "p90", "p99"):
            assert abs(row[k] - want[k]) <= 0.02, (row, want, k)
        for k in ("frac_gt_1cell", "frac_gt_4cell"):
            assert abs(row[k] - want[k]) <= 0.005, (row, want, k)


def test_generalization_study_writes_jax_columns(tmp_path, capsys):
    out = str(tmp_path / "gen.csv")
    rows = generalization_study.main(
        ["--iters", "1", "--envs", "18", "--rollout", "2", "--eval-envs-per-track", "1",
         "--eval-steps", "5", "--rt-stride", "16", "--device", "cpu", "--log-csv", out])
    with open(os.path.join(ROOT, "docs", "media", "generalization.csv")) as f:
        jax_header = next(csv.reader(f))
    with open(out) as f:
        got = list(csv.DictReader(f))
    # JAX's five columns, then the two start-line crossing diagnostics
    assert list(got[0]) == jax_header + ["cross_lat_abs_mean", "cross_out_of_band"] \
        == generalization_study.FIELDS
    names = [os.path.basename(p)[:-5] for p in assets.packaged_tracks()]
    assert [r["track"] for r in got] == names and len(got) == 11
    assert [r["split"] for r in got] == ["train"] * 9 + ["holdout"] * 2
    for r in got:
        assert all(np.isfinite(float(r[k])) for k in jax_header[2:])
        # 5 steps from the start line: no forward crossing yet
        assert all(np.isnan(float(r[k])) for k in generalization_study.FIELDS[5:])
    assert len(rows) == 11
    text = capsys.readouterr().out
    assert "held-out tracks: ['track_narrow', 'track_wide']" in text
    assert re.search(rf"train-split mean speed {FLOAT} m/s; held-out {FLOAT} m/s", text)


def test_mpc_demo_controls_match_jax(capsys):
    path, u_hist, traj, err = mpc_demo.main(["--device", "cpu", "--steps", "30"])
    jc = jmpc.default_mpc_config(jnp.float32)
    want = np.asarray(jmpc.mpc_controller(jnp.asarray(path), jnp.float32(2.0),
                                          jc.timestep, jc.Q, jc.R, jc.Qf,
                                          total_steps=30, horizon=jc.horizon))
    assert u_hist.shape == (30, 2)
    np.testing.assert_allclose(u_hist, want, rtol=1e-5, atol=1e-5)
    traj_j = mpc_demo.replay(path, want, float(jc.timestep))
    assert abs(err - mpc_demo.tracking_error(path, traj_j)) < 1e-4
    assert capsys.readouterr().out.strip() == f"mean nearest-waypoint error {err:.3f} m"
    # a path given as points
    _, u2, _, _ = mpc_demo.main(["--device", "cpu", "--steps", "5", "--points", "0,0",
                                 "2,1", "4,0", "6,-1"])
    assert u2.shape == (5, 2) and np.isfinite(u2).all()


def test_mpc_demo_plots_need_matplotlib(monkeypatch, tmp_path):
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    for flags in (["--out", str(tmp_path / "m.png")], ["--animate", str(tmp_path / "m.gif")],
                  ["--draw"]):
        with pytest.raises(SystemExit, match="matplotlib"):
            mpc_demo.main(["--device", "cpu", "--steps", "3", *flags])


def test_lidar_bitmap_frames_match_jax(tmp_path, capsys):
    frames = lidar_bitmap_example.main(["--steps", "101", "--every", "50", "--device",
                                        "cpu", "--outdir", str(tmp_path)])
    assert [t for t, _, _ in frames] == [0, 50, 100]
    for t, scan, imgs in frames:
        assert float(scan.min()) > 0.0
        for mode, img in imgs.items():
            want = np.asarray(jbitmap(jnp.asarray(scan.numpy()), bg_color="black",
                                      draw_mode=mode))
            np.testing.assert_array_equal(img, want, err_msg=f"{mode} at step {t}")
            png = read_png(str(tmp_path / f"{mode.lower()}_{t:05d}.png"))[0]
            np.testing.assert_array_equal(png, img)
    lines = capsys.readouterr().out.splitlines()
    assert lines[:3] == [f"step {t}: wrote 3 bitmaps" for t in (0, 50, 100)]
    assert lines[-1] == f"frames in {tmp_path}"
