"""Batched rollout drivers: a Python loop over time with auto-reset on done.

PyTorch counterpart of ``red_gym_tpu/rollout.py``.  The env functions are
already batched over a leading env axis, so ``batched_reset`` and
``batched_step`` are the plain calls; ``make_rollout`` replaces the JAX
package's ``lax.scan`` with a loop.  Multi-map params (``map_idx``) and
``randomize_starts`` are not ported yet.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from red_gym_tpu_torch.config import SimConfig
from red_gym_tpu_torch.env import EnvParams, EnvState, Observation, reset, step


def batched_reset(cfg: SimConfig, params: EnvParams, poses, gen):
    """Reset E envs at poses (E, A, 3) -> (state, obs, reward, done, info)."""
    return reset(cfg, params, poses, gen)


def batched_step(cfg: SimConfig, params: EnvParams, states, actions, gen):
    """Step E envs: actions (E, A, 2)."""
    return step(cfg, params, states, actions, gen)


class RolloutCarry(NamedTuple):
    state: EnvState   # batched (E, ...)
    obs: Observation  # batched


def _select(new: NamedTuple, old: NamedTuple, idx) -> NamedTuple:
    """``old`` with the rows ``idx`` of every field replaced by ``new``
    (whose rows are exactly those envs)."""
    fields = []
    for a, b in zip(new, old):
        b = b.clone()
        b[idx] = a
        fields.append(b)
    return type(old)(*fields)


def make_rollout(cfg: SimConfig, params: EnvParams,
                 policy: Callable[[Observation, torch.Generator], torch.Tensor],
                 steps: int):
    """Build ``run(carry, gen) -> (carry, outs)`` over ``steps`` steps.

    ``policy(obs, gen) -> actions (E, A, 2)``.  On done, an env restarts
    from its start pose (one zero-action step, as ``reset``); only the done
    envs are re-stepped.  ``outs`` holds the per-step ``reward`` and
    ``done``, stacked (steps, E), and ``resets``, the number of steps that
    reset some env."""

    def run(carry: RolloutCarry, gen: torch.Generator):
        rewards, dones, resets = [], [], 0
        state, obs = carry
        for _ in range(steps):
            actions = policy(obs, gen)
            state, obs, reward, done, _ = step(cfg, params, state, actions, gen)
            idx = torch.nonzero(done).squeeze(1)
            if idx.numel():
                resets += 1
                r_state, r_obs, *_ = reset(cfg, params, state.start_pose[idx], gen)
                state = _select(r_state, state, idx)
                obs = _select(r_obs, obs, idx)
            rewards.append(reward)
            dones.append(done)
        return RolloutCarry(state, obs), {"reward": torch.stack(rewards),
                                          "done": torch.stack(dones),
                                          "resets": resets}

    return run


def random_policy(cfg: SimConfig, steer_scale: float = 0.4,
                  speed_lo: float = 1.0, speed_hi: float = 8.0):
    """Uniform random actions (the reference dataset collector's driving
    policy, f1tenth_gym/examples/lidar.py)."""

    def policy(obs: Observation, gen: torch.Generator):
        shape = obs.scans.shape[:2]
        dev, dt = obs.scans.device, obs.scans.dtype
        steer = steer_scale * (2.0 * torch.rand(shape, generator=gen, dtype=dt,
                                                device=dev) - 1.0)
        speed = speed_lo + (speed_hi - speed_lo) * torch.rand(
            shape, generator=gen, dtype=dt, device=dev)
        return torch.stack([steer, speed], dim=-1)

    return policy
