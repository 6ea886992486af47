"""The simulator's end-to-end metrics count the whole window: every step's
env-steps over the window's time, and the 95th percentile over every
step; a stall inside the window moves both."""

import time

import pytest
import torch
from conftest import tiny

from harness import clock, sim


def run_tiny(cell, monkeypatch, stall_at=None, stall_s=0.0):
    from red_gym_tpu_torch import env

    real, calls = env.step, []

    def step(*a, **k):
        calls.append(1)
        if stall_at is not None and len(calls) == stall_at:
            time.sleep(stall_s)
        return real(*a, **k)

    monkeypatch.setattr(env, "step", step)
    return sim.run(tiny(cell), 7, 1.0, False, torch.device("cpu"))


def test_rate_counts_the_whole_window(cells, monkeypatch):
    cell = cells["fast_default.random"]
    run = run_tiny(cell, monkeypatch)
    c = run.counters
    assert c["window_s"] >= 1.0
    assert run.end_to_end["env_steps_per_s"] == pytest.approx(
        c["envs"] * c["steps"] / c["window_s"])
    assert sum(c["step_ms"]) / 1e3 == pytest.approx(c["window_s"], rel=0.05)
    assert len(c["step_ms"]) == c["steps"] == run.attempted


def test_a_stall_moves_the_rate_and_the_tail(cells, monkeypatch):
    cell = cells["fast_default.random"]
    # the reset's step and the warm-up's come first: stall a step of the window
    warm = 1 + tiny(cell).traffic["warmup_steps"]
    run = run_tiny(cell, monkeypatch, stall_at=warm + 3, stall_s=0.6)
    c = run.counters
    assert max(c["step_ms"]) >= 600.0
    steady = sorted(c["step_ms"])[len(c["step_ms"]) // 2]
    assert c["envs"] * c["steps"] / c["window_s"] == pytest.approx(
        run.end_to_end["env_steps_per_s"])
    # the stalled 0.6 s holds no steps: the rate is that of the other 0.4 s
    assert c["steps"] * steady / 1e3 < 0.7 * c["window_s"]


def test_p95_is_over_every_step(cells, monkeypatch):
    cell = cells["fast_default.random"]
    run = run_tiny(cell, monkeypatch)
    ms = run.counters["step_ms"]
    assert run.end_to_end["step_ms_p95"] == pytest.approx(clock.percentile(ms, 95.0))
    assert clock.percentile(list(range(101)), 95.0) == 95.0
    assert clock.percentile([1.0, 2.0], 50.0) == 1.5
