"""The tooling examples' command lines on the CPU at tiny sizes.

Each ``red_gym_tpu_torch.examples`` script runs with ``--device cpu`` (or
``F110_CPU``) and must print the lines of its JAX counterpart under
``examples/`` (the same f-strings; only the values differ) and write files
with the JAX script's keys, shapes and dtypes.
"""

import re

import numpy as np
import pytest
import torch

from red_gym_tpu_torch.examples import (collect_lidar_dataset, export_policy,
                                        param_search_cma, waypoint_follow,
                                        waypoint_follow_compat)

FLOAT = r"-?\d+\.\d+"


def _lines(capsys):
    return capsys.readouterr().out.strip().splitlines()


def test_param_search_cma_cli(capsys):
    torch.set_num_threads(2)
    best, best_f = param_search_cma.main(["--popsize", "4", "--generations", "2",
                                          "--steps", "30", "--beams", "16",
                                          "--device", "cpu"])
    lines = _lines(capsys)
    assert [ln.split(":")[0] for ln in lines[:2]] == ["gen 0", "gen 1"]
    assert re.fullmatch(rf"gen 1: best {FLOAT}s  mean {FLOAT}s  sigma {FLOAT}", lines[1])
    assert re.fullmatch(rf"best two-lap time: {FLOAT}s with \{{'m': .*'vgain': .*\}}",
                        lines[2]), lines[2]
    assert re.fullmatch(rf"8 full-rollout evaluations in {FLOAT}s \({FLOAT} rollouts/s, "
                        r"30 steps each\)", lines[3]), lines[3]
    assert set(best) == {"m", "lf", "tlad", "vgain"} and np.isfinite(best_f)


def test_export_serve_and_race_cli(tmp_path, capsys):
    torch.set_num_threads(2)
    out = str(tmp_path / "racer.pt2")
    export_policy.main(["--out", out, "--device", "cpu"])
    lines = _lines(capsys)
    assert lines[0] == "WARNING: no --ckpt given, exporting random-init weights"
    assert re.fullmatch(rf"exported {re.escape(out)}: {FLOAT} MB, device=cpu, symbolic "
                        r"batch, in=\['\(\w+, 1080\)', '\(\w+,\)'\]", lines[1]), lines[1]
    controls = export_policy.main(["--serve", out, "--batch", "7", "--device", "cpu"])
    lines = _lines(capsys)
    assert lines[0].startswith(f"loaded {out}: device=cpu, in=")
    assert re.fullmatch(r"controls\[0\] = \[.*\]; \d+ us/call at batch 7 \([\d,]+ agents/s\)",
                        lines[1]), lines[1]
    assert controls.shape == (7, 2)
    steps, laps, speed, crashes = export_policy.main(
        ["--race", out, "--race-steps", "6", "--scan-mode", "exact", "--device", "cpu"])
    assert re.fullmatch(rf"raced 6 steps: laps=0, mean speed {FLOAT} m/s, collision steps \d+",
                        _lines(capsys)[0])
    assert steps == 6 and np.isfinite(speed)


def test_export_restores_a_train_ppo_checkpoint(tmp_path, capsys):
    from red_gym_tpu_torch.agents import ppo as ppolib
    from red_gym_tpu_torch.utils import checkpoint as ckpt

    policy = ppolib.ScanPolicy()
    policy.reset_parameters(torch.Generator().manual_seed(3))
    opt = torch.optim.Adam(policy.parameters())
    path = str(tmp_path / "ppo_ckpt.pt")
    ckpt.save(path, ppolib.PPOState(policy, opt, torch.Generator()))
    ep = export_policy.main(["--ckpt", path, "--out", str(tmp_path / "r.pt2"),
                             "--device", "cpu"])
    assert _lines(capsys)[0] == f"restored weights from {path}"
    scan, vel = torch.rand(2, 1080) * 10, torch.rand(2)
    with torch.no_grad():
        want = ppolib.action_to_control(policy(scan, vel)[0], ppolib.PPOConfig(),
                                        torch.float32)
        np.testing.assert_allclose(ep.module()(scan, vel).numpy(), want.numpy(),
                                   rtol=0, atol=1e-6)


def test_waypoint_follow_cli(tmp_path, capsys):
    torch.set_num_threads(2)
    png = str(tmp_path / "traj.png")
    sim_time, done = waypoint_follow.main(["--steps", "12", "--device", "cpu",
                                           "--render", png])
    lines = _lines(capsys)
    assert lines[0] == "backend=cpu steps=12"
    assert lines[1] == "Sim elapsed time: nan (two laps done: False)"
    assert re.fullmatch(rf"Real elapsed time: {FLOAT}s \(\d+ steps/s; first call incl. "
                        rf"compile {FLOAT}s\)", lines[2]), lines[2]
    assert lines[3] == f"wrote {png}" and not done
    with open(png, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_waypoint_follow_compat_loop(monkeypatch, capsys):
    torch.set_num_threads(2)
    monkeypatch.setenv("F110_CPU", "1")
    monkeypatch.setenv("F110_MAX_STEPS", "10")
    laptime, steps = waypoint_follow_compat.main()
    assert steps == 10 and laptime == pytest.approx(0.1)
    assert re.fullmatch(rf"Sim elapsed time: {FLOAT} Real elapsed time: {FLOAT}",
                        _lines(capsys)[0])


def test_collect_lidar_dataset_cli(tmp_path, capsys):
    torch.set_num_threads(2)
    out, legacy = str(tmp_path / "ds.npz"), str(tmp_path / "legacy.npz")
    collect_lidar_dataset.main(["--episodes", "3", "--steps", "2", "--image-size", "64",
                                "--device", "cpu", "--out", out, "--legacy-npz", legacy])
    lines = _lines(capsys)
    assert lines[0] == f"wrote {out}: bitmaps (2, 3, 64, 64), scans (2, 3, 1080)"
    assert lines[1] == f"wrote {legacy}: data (6, 256, 256) uint8 (reference collector schema)"
    with np.load(out) as z:
        assert sorted(z.files) == ["actions", "bitmaps", "scans", "spawns"]
        want = {"bitmaps": ((2, 3, 64, 64), np.uint8), "scans": ((2, 3, 1080), np.float32),
                "actions": ((2, 3, 2), np.float32), "spawns": ((3, 3), np.float32)}
        for k, (shape, dtype) in want.items():
            assert z[k].shape == shape and z[k].dtype == dtype, k
        assert set(np.unique(z["bitmaps"])) <= {0, 255} and np.isfinite(z["scans"]).all()
        act = z["actions"]
        assert np.all(np.abs(act[..., 0]) <= 0.4) and np.all((act[..., 1] >= 1) & (act[..., 1] <= 5))
    with np.load(legacy) as z:
        assert z.files == ["data"] and z["data"].dtype == np.uint8
