"""Runner ``train``: the PPO trainer, ``PPO.train_step`` after
``PPO.train_step``, as ``examples/train_ppo.py`` runs it (each iteration's
metrics read on the host at its end).

Set-up makes the envs as the ``sim`` runner does, builds one trainer
(``agents.ppo.PPO``) and its state, puts the benchmark's own first
weights into the policy, and drives that same object through the
traffic's ``checked_iters`` iterations, recording what the reference
needs: each rollout, the minibatch permutations, the optimizer's first
step, the weights after the last, and a few env steps whole.  The
window then runs ``train_step`` for ``--seconds`` (``--trace 0``) or the
traffic's ``trace_iters`` under the profiler (``--trace 1``).
"""

from __future__ import annotations

import contextlib
import random

from harness import checks, clock, inputs, result, sim, trace as tracing


class Recorder:
    """Wraps the program's env step and reset inside ``collect`` (the names
    ``agents.ppo.step`` and ``rollout.reset_done``), ``collect`` itself and
    the epochs' permutation draw, and keeps what the reference needs."""

    def __init__(self, ppo, check: dict, seed: int):
        self.seed = seed
        rng = random.Random(seed)
        span = range(check["first"], check["last"])
        self.wanted = set(rng.sample(span, check["steps"]))
        self.reset_from = rng.choice(span)
        self.ppo = ppo
        self.t = -1
        self.pending = None
        self.steps: list[sim.StepRecord] = []
        self.rollouts, self.perms = [], []

    @contextlib.contextmanager
    def active(self):
        from red_gym_tpu_torch import rollout
        from red_gym_tpu_torch.agents import ppo as ppo_mod

        step, reset_done, perm = ppo_mod.step, rollout.reset_done, ppo_mod.epoch_permutation
        collect = self.ppo.collect

        def rec_step(cfg, params, s, ctrl, gen):
            self.t += 1
            g = gen.get_state()
            out = step(cfg, params, s, ctrl, gen)
            self.pending = (self.t, s, ctrl, g, (out[0], out[1], out[3]))
            return out

        def rec_reset(cfg, params, s, obs, done, gen, *a, **k):
            g = gen.get_state()
            s2, o2, any_ = reset_done(cfg, params, s, obs, done, gen, *a, **k)
            t, s0, ctrl, g0, mid = self.pending
            if t in self.wanted or (any_ and t >= self.reset_from
                                    and not any(r.reset_any for r in self.steps)):
                self.steps.append(sim.StepRecord(t, s0, ctrl, g0, mid, g, (s2, o2),
                                                 bool(any_)))
            return s2, o2, any_

        def rec_perm(n, gen, device):
            p = perm(n, gen, device)
            self.perms[-1].append(p)
            return p

        def rec_collect(*a, **k):
            out = collect(*a, **k)
            self.rollouts.append(out)
            self.perms.append([])
            return out

        ppo_mod.step, rollout.reset_done, ppo_mod.epoch_permutation = (
            rec_step, rec_reset, rec_perm)
        self.ppo.collect = rec_collect
        try:
            yield self
        finally:
            ppo_mod.step, rollout.reset_done = step, reset_done
            ppo_mod.epoch_permutation = perm
            del self.ppo.collect


@contextlib.contextmanager
def first_adam_moment(opt):
    """Inside, ``opt.step`` keeps each parameter's first moment after the
    first step: yields {param: exp_avg}."""
    kept, step = {}, opt.step

    def rec(*a, **k):
        out = step(*a, **k)
        if not kept:
            for group in opt.param_groups:
                for q in group["params"]:
                    kept[q] = opt.state[q]["exp_avg"].detach().clone()
        return out

    opt.step = rec
    try:
        yield kept
    finally:
        del opt.step


def run(cell, seed: int, seconds: float, trace: bool, device,
        check=checks.train) -> result.Run:
    import torch

    from red_gym_tpu_torch.agents.ppo import PPO, PPOConfig, ScanPolicy

    traffic = cell.traffic
    cfg, params, maps, gen, states, obs = sim.setup(cell, seed, device)
    e_n = states.x.shape[0]
    pcfg = PPOConfig(**cell.config["ppo"])
    ppo = PPO(cfg, params, pcfg, policy=ScanPolicy(cfg.num_beams, **cell.config["policy"]))
    pstate = ppo.init(torch.Generator().manual_seed(seed))
    policy = pstate.policy
    named = dict(policy.named_parameters())
    weights = inputs.policy_weights({k: tuple(v.shape) for k, v in named.items()},
                                    seed, device)
    with torch.no_grad():
        for k, v in named.items():
            v.copy_(weights[k])

    rec = Recorder(ppo, traffic["check"], seed)
    losses = []
    with rec.active(), first_adam_moment(pstate.optimizer) as kept:
        for _ in range(traffic["checked_iters"]):
            pstate, states, obs, m = ppo.train_step(pstate, states, obs)
            losses.append(float(m["loss"]))
    after = {k: v.detach().clone() for k, v in named.items()}
    # Adam's first moment after one step is (1 - beta1) g; None if no step ran
    beta1 = pstate.optimizer.param_groups[0]["betas"][0]
    first_grad = {k: kept[v] / (1 - beta1) for k, v in named.items()} if kept else None
    clock.sync(device)
    setup_s = clock.process_age_s()
    clock.say(f"checked iterations' losses {losses}; recorded env steps "
              f"{[(r.index, r.reset_any) for r in rec.steps]}")

    iters, traces = 0, []
    if trace:
        with tracing.traced(traces, device):
            t0 = clock.now()
            for _ in range(traffic["trace_iters"]):
                pstate, states, obs, m = ppo.train_step(pstate, states, obs)
                float(m["loss"])
                iters += 1
            t_end = clock.now()
    else:
        clock.sync(device)
        t0 = t_end = clock.now()
        while t_end - t0 < seconds:
            pstate, states, obs, m = ppo.train_step(pstate, states, obs)
            float(m["loss"])
            iters += 1
            t_end = clock.now()
    peak = clock.peak_bytes(device)
    window_s = t_end - t0
    clock.say(f"window: {iters} iterations in {window_s:.3f} s")

    del ppo, pstate, params, states, obs, policy, named
    clock.release(device)
    numbers = check(cell, maps, weights, rec, losses, first_grad, after, device)
    steps = e_n * pcfg.rollout_len * iters
    return result.Run(
        setup_s=setup_s,
        end_to_end={"train_env_steps_per_s": steps / window_s},
        counters={"iterations": iters, "steps": pcfg.rollout_len * iters, "envs": e_n,
                  "agents": cfg.num_agents, "beams": cfg.num_beams,
                  "theta_bins": cfg.rt_theta_bins, "window_s": window_s,
                  "checked_steps": [r.index for r in rec.steps]},
        attempted=iters, memory_peak_bytes=peak, checks=numbers,
        trace=traces[0] if traces else None)
