"""The comparison fails a broken program: the harness runs a tiny cell on
the CPU (past its look for a card) with a fault planted under the timed
path, and ``correct`` comes out false, once for each fault a cell can have
on one chip.  Without a fault it comes out true (on the CPU both sides run
the same twins)."""

import pytest
import torch
from conftest import tiny

from harness import sim, train

CPU = torch.device("cpu")


def patch_step(monkeypatch, module, fault):
    real = module.step

    def step(cfg, params, state, actions, gen):
        s, o, r, d, info = real(cfg, params, state, actions, gen)
        return fault(state, s, o, r, d, info)

    monkeypatch.setattr(module, "step", step)


def unchanged(state, s, o, r, d, info):
    return state, o, r, d, info


def half_envs(state, s, o, r, d, info):
    half = s.x.shape[0] // 2
    x = s.x.clone()
    x[half:] = state.x[half:]
    return s._replace(x=x), o, r, d, info


def altered(state, s, o, r, d, info):
    scans = o.scans.clone()
    scans[0, 0] += 0.5
    return s, o._replace(scans=scans), r, d, info


def altered_every_env(state, s, o, r, d, info):
    scans = o.scans.clone()
    scans[:, 0, 0] += 0.5
    return s, o._replace(scans=scans), r, d, info


def test_sim_without_fault_is_correct(cells):
    assert sim.run(tiny(cells["fast_default.random"]), 11, 0.3, False, CPU).correct


@pytest.mark.parametrize("fault", [unchanged, half_envs, altered])
def test_sim_fault_is_caught(cells, monkeypatch, fault):
    from red_gym_tpu_torch import env

    patch_step(monkeypatch, env, fault)
    run = sim.run(tiny(cells["fast_default.random"]), 11, 0.3, False, CPU)
    assert not run.correct, run.checks


def test_train_without_fault_is_correct(cells):
    run = train.run(tiny(cells["ppo_multimap.train"]), 12, 0.3, False, CPU)
    assert run.correct, run.checks


def test_train_step_that_leaves_the_state_unchanged_is_caught(cells, monkeypatch):
    from red_gym_tpu_torch.agents.ppo import PPO

    real = PPO._update

    def frozen(self, pstate, traj, last_value, _perms=None):
        saved = [q.detach().clone() for q in pstate.policy.parameters()]
        out = real(self, pstate, traj, last_value, _perms)
        with torch.no_grad():
            for q, v in zip(pstate.policy.parameters(), saved):
                q.copy_(v)
        return out

    monkeypatch.setattr(PPO, "_update", frozen)
    run = train.run(tiny(cells["ppo_multimap.train"]), 12, 0.3, False, CPU)
    assert not run.correct, run.checks


def test_train_half_batch_is_caught(cells, monkeypatch):
    from red_gym_tpu_torch.agents.ppo import PPO

    real = PPO._loss

    def half(self, policy, batch, mb=None):
        return real(self, policy, [x[: x.shape[0] // 2] for x in batch], None)

    monkeypatch.setattr(PPO, "_loss", half)
    run = train.run(tiny(cells["ppo_multimap.train"]), 12, 0.3, False, CPU)
    assert not run.correct, run.checks


def test_train_altered_observation_is_caught(cells, monkeypatch):
    from red_gym_tpu_torch.agents import ppo

    patch_step(monkeypatch, ppo, altered_every_env)
    run = train.run(tiny(cells["ppo_multimap.train"]), 12, 0.3, False, CPU)
    assert not run.correct, run.checks
