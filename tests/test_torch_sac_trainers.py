"""The port's three SAC trainers (``red_gym_tpu_torch/examples/train_sac*.py``)
on the CPU at tiny sizes: their CSV columns are the JAX scripts', then the
update's diagnostics (``agents.sac.UPDATE_DIAGNOSTICS``), a run resumes
from its checkpoint at the saved iteration, and each iteration fills the
replay and restarts done envs as the JAX loops do."""

import csv
import dataclasses
import math
import os

import torch

from red_gym_tpu_torch.agents.sac import UPDATE_DIAGNOSTICS
from red_gym_tpu_torch.examples import train_sac, train_sac_bitmap_scale, train_sac_scale
from red_gym_tpu_torch.utils import checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BITMAP_ARGS = ["--device", "cpu", "--envs", "3", "--steps-per-iter", "3", "--bitmap", "64",
               "--beams", "108", "--capacity", "20", "--batch-size", "4", "--f32",
               "--warmup-iters", "1"]


def _header(path):
    with open(path) as f:
        return next(csv.reader(f))


def _csv_literal(path):
    """The CSV header a script writes: the first string literal of its
    source that starts with "iter,env_steps"."""
    with open(os.path.join(ROOT, path)) as f:
        line = next(ln for ln in f if '"iter,env_steps' in ln)
    return line.split('"')[1].replace("\\n", "").split(",")


def test_bitmap_trainer_csv_and_resume(tmp_path):
    log, ckpt = str(tmp_path / "curve.csv"), str(tmp_path / "sac.pt")
    t = train_sac_bitmap_scale.main(BITMAP_ARGS + ["--iters", "2", "--log-csv", log,
                                                   "--save", ckpt])
    assert _header(log) == (_csv_literal("examples/train_sac_bitmap_scale.py")
                            + list(UPDATE_DIAGNOSTICS))
    with open(log) as f:
        rows = list(csv.DictReader(f))
    assert [int(r["env_steps"]) for r in rows] == [9, 18]
    assert float(rows[0]["actor_loss"]) == 0.0 and float(rows[1]["actor_loss"]) != 0.0
    # the warm-up reports no update; the update iteration finite diagnostics
    assert all(float(rows[0][k]) == 0.0 for k in UPDATE_DIAGNOSTICS)
    assert all(math.isfinite(float(rows[1][k])) for k in UPDATE_DIAGNOSTICS)
    assert float(rows[1]["actor_grad_norm"]) > 0.0
    assert (t.buf.size, t.buf.ptr) == (18, 18)
    assert checkpoint.restore(ckpt)["it"] == 2
    # the resumed run starts at iteration 2
    train_sac_bitmap_scale.main(BITMAP_ARGS + ["--iters", "3", "--log-csv", log,
                                               "--resume", ckpt])
    with open(log) as f:
        assert [int(r["iter"]) for r in csv.DictReader(f)] == [0, 1, 2]


def test_bitmap_trainer_restarts_done_envs():
    """Envs driven into a wall end, restart on their start poses and the
    replay's dones say so."""
    args = train_sac_bitmap_scale.parse_args(BITMAP_ARGS)
    t = train_sac_bitmap_scale.build(args)
    x = t.ps.env_state.x.clone()
    x[0, 0, 5] = 1e35                     # env 0 diverges: done at the next step
    t.ps = t.ps._replace(env_state=t.ps.env_state._replace(x=x))
    _, resets = train_sac_bitmap_scale.iteration(t, False)
    assert resets >= 1
    assert float(t.buf.done[0]) == 1.0 and float(t.buf.reward[0]) == -100.0
    assert torch.isfinite(t.ps.env_state.x).all()


def test_scan_trainer_iterations(tmp_path):
    args = train_sac_scale.parse_args(["--device", "cpu", "--envs", "4", "--beams", "108",
                                       "--capacity", "50", "--batch-size", "8",
                                       "--steps-per-iter", "3"])
    # a coarse texture: the default stride-2 build takes minutes on the CPU
    cfg = dataclasses.replace(train_sac_scale.make_config(args), rt_pose_stride=16)
    t = train_sac_scale.build(args, cfg)
    assert t.cfg.scan_interp == "spectral"
    before = [p.clone() for p in t.sstate.actor.parameters()]
    for do_update in (False, True):
        train_sac_scale.iteration(t, do_update)
    assert (t.buf.size, t.buf.ptr) == (24, 24)
    assert not all(torch.equal(a, b) for a, b in zip(before, t.sstate.actor.parameters()))
    assert _csv_literal("red_gym_tpu_torch/examples/train_sac_scale.py") == \
        _csv_literal("examples/train_sac_scale.py")


def test_one_env_trainer_updates_on_schedule(tmp_path, capsys):
    ckpt = str(tmp_path / "actor.pt")
    t = train_sac.main(["--device", "cpu", "--episodes", "1", "--steps", "7", "--update-after",
                        "2", "--update-every", "2", "--bitmap", "64", "--replay-capacity", "20",
                        "--batch-size", "4", "--save", ckpt])
    out = capsys.readouterr().out
    # updates at the steps past --update-after that --update-every divides
    assert [ln.split(":")[0] for ln in out.splitlines() if ln.startswith("step")] == \
        [f"step {s}" for s in (4, 6) if s <= t.total_steps]
    assert t.buf.size == t.total_steps
    got = checkpoint.restore(ckpt, like=t.sac.init(torch.Generator().manual_seed(5)))
    obs = t.buf.obs[:2]
    assert torch.equal(t.sac.select_action(t.sstate, obs, evaluate=True),
                       t.sac.select_action(got, obs, evaluate=True))
