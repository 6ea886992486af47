"""The reference agrees with the port's plain twins at a small size on the
CPU: the frozen simulator step for step, restarts included, and the PPO
learner with the trainer's update."""

import pytest
import torch
from conftest import tiny

from harness import checks, inputs, sim


def test_reference_steps_equal_the_programs(cells):
    """Both sides on the CPU run the same twins: every number reads 0 on
    steps with and without restarts."""
    import refsim.env
    import refsim.rollout
    from red_gym_tpu_torch import env, rollout

    cell = tiny(cells["fast_default.random"])
    cfg, params, maps, gen, state, obs = sim.setup(cell, 3, torch.device("cpu"))
    # envs 0-2 start with both cars on one pose: they collide and restart
    poses = state.start_pose.clone()
    poses[:3, 1] = poses[:3, 0]
    state, obs, *_ = rollout.batched_reset(cfg, params, poses, gen)
    rcfg, rparams = checks.reference_sim(cell, maps, torch.device("cpu"))
    assert torch.equal(params.rtex.rt, rparams.rtex.rt)
    gaps, restarts = checks.Gaps(), 0
    rgen = torch.Generator()
    for i in range(40):
        actions = sim.uniform_actions(cell.traffic["policy"], *state.x.shape[:2], gen,
                                      cfg.tdtype, "cpu")
        rgen.set_state(gen.get_state())
        s1, o1, _, done, _ = env.step(cfg, params, state, actions, gen)
        r1, ro1, _, rdone, _ = refsim.env.step(rcfg, rparams, refsim.env.EnvState(*state),
                                               actions, rgen)
        gaps.add((s1, o1, done), (r1, ro1, rdone))
        s2, o2, any_ = rollout.reset_done(cfg, params, s1, o1, done, gen)
        r2, ro2, rany = refsim.rollout.reset_done(rcfg, rparams, refsim.env.EnvState(*s1),
                                                  refsim.env.Observation(*o1), done, rgen)
        gaps.add((s2, o2, None), (r2, ro2, None))
        assert any_ == rany
        restarts += any_
        state = s2
    assert restarts > 0
    assert gaps.numbers() == {"scan_p99_m": 0.0, "scan_far_pct": 0.0, "state_gap": 0.0,
                              "flags_differ": 0.0}


def test_reference_learner_follows_the_trainers_update(cells):
    import ppo_update
    from red_gym_tpu_torch.agents.ppo import PPO, PPOConfig, ScanPolicy

    cell = tiny(cells["ppo_multimap.train"])
    cfg, params, maps, gen, states, obs = sim.setup(cell, 5, torch.device("cpu"))
    h = cell.config["ppo"]
    ppo = PPO(cfg, params, PPOConfig(**h),
              policy=ScanPolicy(cfg.num_beams, **cell.config["policy"]))
    pstate = ppo.init(torch.Generator().manual_seed(5))
    named = dict(pstate.policy.named_parameters())
    w0 = inputs.policy_weights({k: tuple(v.shape) for k, v in named.items()}, 5, "cpu")
    with torch.no_grad():
        for k, v in named.items():
            v.copy_(w0[k])
    states, obs, traj = ppo.collect(pstate, states, obs)
    feats = torch.log1p(obs.scans[:, 0, ::8].float())
    _, _, last_value = pstate.policy(feats, obs.linear_vels_x[:, 0], featurized=True)
    n = traj.rewards.numel()
    g = torch.Generator().manual_seed(9)
    perms = [torch.randperm(n, generator=g) for _ in range(h["epochs"])]
    upd = ppo._update(pstate, traj, last_value.detach(), _perms=perms)
    learner = ppo_update.Learner(w0, h)
    loss, _ = learner.iteration({"feats": traj.feats, "vels": traj.vels, "acts": traj.acts,
                              "rewards": traj.rewards, "dones": traj.dones},
                             feats, obs.linear_vels_x[:, 0], perms)
    assert loss == pytest.approx(float(upd["loss"]), rel=1e-4, abs=1e-6)
    # Adam's step of an entry whose gradient is near 0 swings with its
    # rounding: compare each leaf's change by its norm, as the check does
    change_p = {k: v.detach() - w0[k] for k, v in named.items()}
    change_r = {k: v.detach() - w0[k] for k, v in learner.w.items()}
    assert checks.worst_leaf(change_p, change_r, list(w0)) < 1e-4
