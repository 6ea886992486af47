"""Runner ``sim``: the simulator's step loop, closed loop, one step after
another, as ``rollout.make_rollout`` runs it: the traffic's policy draws
the actions, ``env.step`` steps every env, ``rollout.reset_done`` restarts
the done ones (reading ``done`` on the host).

Set-up makes the params (map, lidar tables, range texture marched on the
card), resets the envs at their start poses and runs the traffic's
warm-up steps.  The window then steps for ``--seconds`` (``--trace 0``) or
for the traffic's ``trace_steps`` under the profiler (``--trace 1``).
A few steps drawn from the seed are recorded whole, inputs and outputs,
and held to the reference once the window has closed (``checks.sim``).
"""

from __future__ import annotations

import os
import random
from typing import NamedTuple

import numpy as np

from harness import checks, clock, inputs, result, trace as tracing

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def uniform_actions(policy: dict, e_n: int, a_n: int, gen, dtype, device):
    """(E, A, 2) [steer, speed]: steer U(-s, s), speed U(lo, hi), drawn as
    ``rollout.random_policy`` draws them (steer first, then speed)."""
    import torch

    s = policy["steer"]
    lo, hi = policy["speed"]
    steer = s * (2.0 * torch.rand((e_n, a_n), generator=gen, dtype=dtype,
                                  device=device) - 1.0)
    speed = lo + (hi - lo) * torch.rand((e_n, a_n), generator=gen, dtype=dtype,
                                        device=device)
    return torch.stack([steer, speed], dim=-1)


class StepRecord(NamedTuple):
    """One step of the window, whole: what went in and what came out."""

    index: int
    state: object        # EnvState before the step
    actions: object
    gen_step: object     # the generator's state before the step
    mid: tuple           # (state, obs, done) after env.step
    gen_reset: object    # the generator's state before reset_done
    out: tuple           # (state, obs) after reset_done
    reset_any: bool


def record_plan(check: dict, seed: int) -> tuple[set, int]:
    """Steps to record: ``check["steps"]`` indices drawn from the seed in
    [first, last), and the first step at or after a drawn index that
    restarts some env."""
    rng = random.Random(seed)
    span = range(check["first"], check["last"])
    return set(rng.sample(span, check["steps"])), rng.choice(span)


def setup(cell, seed: int, device):
    """The program's params, envs and generator for the cell."""
    import torch

    from red_gym_tpu_torch import env, rollout
    from red_gym_tpu_torch.config import Integrator, SimConfig

    cfg = inputs.sim_settings(cell.config, SimConfig, Integrator)
    maps = inputs.map_paths(cell.config, ROOT)
    e_n = cell.config["envs"]
    table = torch.as_tensor(np.stack(
        [inputs.start_poses(m, cfg.num_agents, cell.config["start_rows_apart"])
         for m in maps]), dtype=cfg.tdtype, device=device)
    if len(maps) == 1:
        params = env.make_params(cfg, maps[0], device=device)
        map_idx = None
        poses = table[0].expand(e_n, cfg.num_agents, 3).contiguous()
    else:
        params = env.make_multimap_params(cfg, maps, device=device)
        map_idx = (torch.arange(e_n, device=device) % len(maps)).to(torch.int32)
        poses = table[map_idx.long()]
    clock.say(f"params of {len(maps)} map(s) made")
    gen = torch.Generator(device=device).manual_seed(seed)
    state, obs, *_ = rollout.batched_reset(cfg, params, poses, gen, map_idx=map_idx)
    return cfg, params, maps, gen, state, obs


def run(cell, seed: int, seconds: float, trace: bool, device,
        check=checks.sim) -> result.Run:
    import torch
    from torch.profiler import record_function

    from red_gym_tpu_torch import env, rollout

    traffic = cell.traffic
    cfg, params, maps, gen, state, obs = setup(cell, seed, device)
    e_n, a_n = state.x.shape[:2]
    policy = traffic["policy"]
    wanted, reset_from = record_plan(traffic["check"], seed)
    records: list[StepRecord] = []

    def one_step(i: int, record: bool):
        nonlocal state, obs
        with record_function("bench/policy"):
            actions = uniform_actions(policy, e_n, a_n, gen, cfg.tdtype, device)
        gen_step = gen.get_state() if record else None
        with record_function("bench/step"):
            s1, o1, _, done, _ = env.step(cfg, params, state, actions, gen)
        gen_reset = gen.get_state() if record else None
        with record_function("bench/reset_done"):
            s2, o2, reset_any = rollout.reset_done(cfg, params, s1, o1, done, gen)
        if record and (i in wanted or (reset_any and i >= reset_from
                                       and not any(r.reset_any for r in records))):
            records.append(StepRecord(i, state, actions, gen_step, (s1, o1, done),
                                      gen_reset, (s2, o2), bool(reset_any)))
        state, obs = s2, o2
        return reset_any

    for _ in range(traffic["warmup_steps"]):
        one_step(-1, False)
    clock.sync(device)
    setup_s = clock.process_age_s()

    last = traffic["check"]["last"]   # steps from here on are not recorded
    stamps, resets, traces = [], 0, []
    if trace:
        with tracing.traced(traces, device):
            t0 = clock.now()
            for i in range(traffic["trace_steps"]):
                resets += bool(one_step(i, i < last))
                stamps.append(clock.now())
    else:
        clock.sync(device)
        t0 = clock.now()
        i = 0
        # the window lasts ``seconds``, and at least until the drawn steps
        while i <= max(wanted) or stamps[-1] - t0 < seconds:
            resets += bool(one_step(i, i < last))
            stamps.append(clock.now())
            i += 1
        clock.sync(device)
    window_s = traces[0].window_s if trace else clock.now() - t0
    steps = len(stamps)
    clock.say(f"window: {steps} steps, {resets} restarting some env, in {window_s:.3f} s; "
              f"recorded steps {[(r.index, r.reset_any) for r in records]}")
    step_ms = [1e3 * (b - a) for a, b in zip([t0] + stamps[:-1], stamps)]
    peak = clock.peak_bytes(device)

    del params, state, obs
    clock.release(device)
    numbers = check(cell, maps, records, device)
    return result.Run(
        setup_s=setup_s,
        end_to_end={"env_steps_per_s": e_n * steps / window_s,
                    "step_ms_p95": clock.percentile(step_ms, 95.0)},
        counters={"steps": steps, "reset_steps": resets, "envs": e_n, "agents": a_n,
                  "beams": cfg.num_beams, "theta_bins": cfg.rt_theta_bins,
                  "window_s": window_s, "step_ms": step_ms,
                  "checked_steps": [r.index for r in records]},
        attempted=steps, memory_peak_bytes=peak, checks=numbers,
        trace=traces[0] if traces else None)
