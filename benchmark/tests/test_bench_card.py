"""Tests on the card (``-m cuda``; they skip without one).

    python -m pytest benchmark/tests -m cuda -q

The harness's step loop makes the launches that ``rollout.make_rollout``
makes over the same steps and ends in the same state; each cell's
untraced and traced runs end with the contract's result line; and each
cell's TF32 control, at a size a test holds, fails its limits."""

import json
import subprocess
import sys

import pytest
import torch
from conftest import ROOT

from harness import controls, sim, train

pytestmark = pytest.mark.cuda


def launches():
    from red_gym_tpu_torch.ops import blend_kernels, march_kernels, scan_kernels, state_kernels

    return {"mega": dict(scan_kernels.mega_edge_ttc.launches),
            "prestep": state_kernels.prestep.launches,
            "blend": {f.__name__: f.launches for f in blend_kernels.KERNELS},
            "march": (march_kernels.march.launches, march_kernels.march_beams.launches)}


def test_step_loop_matches_make_rollout(cells, card):
    from red_gym_tpu_torch import env, rollout
    from red_gym_tpu_torch.ops import (blend_kernels, march_kernels, scan_kernels,
                                       state_kernels)

    cell = cells["fast_default.random"]
    cell = cell._replace(config=dict(cell.config, envs=4096))
    steps = 60
    ends = []
    for how in ("harness", "make_rollout"):
        cfg, params, _, gen, state, obs = sim.setup(cell, 21, card)
        # envs 0-15 start with both cars on one pose: they restart every step
        poses = state.start_pose.clone()
        poses[:16, 1] = poses[:16, 0]
        state, obs, *_ = rollout.batched_reset(cfg, params, poses, gen)
        for reset in (scan_kernels.reset_launches, blend_kernels.reset_launches,
                      march_kernels.reset_launches):
            reset()
        state_kernels.prestep.launches = 0
        if how == "harness":
            for _ in range(steps):
                a = sim.uniform_actions(cell.traffic["policy"], *state.x.shape[:2], gen,
                                        cfg.tdtype, card)
                s, o, _, d, _ = env.step(cfg, params, state, a, gen)
                state, obs, _ = rollout.reset_done(cfg, params, s, o, d, gen)
        else:
            p = cell.traffic["policy"]
            policy = rollout.random_policy(cfg, p["steer"], *p["speed"])
            (state, obs), _ = rollout.make_rollout(cfg, params, policy, steps)(
                rollout.RolloutCarry(state, obs), gen)
        torch.cuda.synchronize()
        ends.append((launches(), state, obs))
    (la, sa, oa), (lb, sb, ob) = ends
    assert la == lb and la["prestep"] == 2 * steps
    for a, b in zip(sa, sb):
        assert (a is None and b is None) or torch.equal(a, b)
    assert torch.equal(oa.scans, ob.scans)


@pytest.mark.parametrize("workload", ["fast_default.random", "ppo_multimap.train"])
@pytest.mark.parametrize("trace", [0, 1])
def test_run_prints_the_result_line(card, workload, trace):
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload, "--seed",
         "4000000001", "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    if trace:
        assert line["device"]["busy_s"] > 0 and line["device"]["window_s"] > 0
        assert len(line["breakdown"]["device_ops"]) <= 10
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("workload,runner", [("fast_default.random", sim),
                                             ("ppo_multimap.train", train)])
def test_tf32_control_fails_the_limits(cells, card, workload, runner):
    cell = cells[workload]
    cell = cell._replace(config=dict(cell.config, envs=4096))
    run = runner.run(cell, 31, 1.0, False, card,
                     check=controls.CONTROLS[cell.traffic["runner"]]["tf32"])
    readings = {k: v for k, v, _ in run.checks}
    assert any(readings[k] > lim for k, lim in cell.limits.items()), readings
