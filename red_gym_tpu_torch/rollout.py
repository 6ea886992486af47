"""Batched rollout drivers: a Python loop over time with auto-reset on done.

PyTorch counterpart of ``red_gym_tpu/rollout.py``.  The env functions are
already batched over a leading env axis, so ``batched_reset`` and
``batched_step`` are the plain calls; ``make_rollout`` replaces the JAX
package's ``lax.scan`` with a loop.

Multi-map batches come in the JAX package's two forms.  ``map_idx`` (E,)
puts each env on its map of map-stacked params
(``env.make_multimap_params``); it lives in ``EnvState.map_idx``.
``map_axis=0`` says that the params' maps (and, in fast mode, textures)
carry a leading env axis, env e on map e: the port runs it as the stack
indexed by ``map_idx = arange(E)``, and the state's ``map_idx`` stays
None, as in JAX.  ``make_rollout(randomize_starts=...)`` draws a done
env's next map and start pose at each auto-reset (domain randomization).
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional

import torch

from red_gym_tpu_torch.config import SimConfig
from red_gym_tpu_torch.env import (EnvParams, EnvState, Observation, check_map_idx,
                                   reset, reset_unchecked, skip_step_draws, step)
from red_gym_tpu_torch.parallel import draws
from red_gym_tpu_torch.utils.profiling import count, span


def _env_maps(params: EnvParams, map_axis, e_n: int, device):
    """The map index that runs ``map_axis=0``: env e on map e, (E,) int32;
    None without a map axis.  Raises ValueError unless the params' maps
    are stacked one an env."""
    if map_axis is None:
        return None
    if map_axis != 0:
        raise ValueError(f"map_axis must be 0 or None, got {map_axis}")
    if params.tmap.dt.dim() != 3 or params.tmap.dt.shape[0] != e_n:
        raise ValueError(f"map_axis=0 needs the params' maps stacked one an env: "
                         f"{e_n} envs, tmap.dt {tuple(params.tmap.dt.shape)}")
    return torch.arange(e_n, dtype=torch.int32, device=device)


def batched_reset(cfg: SimConfig, params: EnvParams, poses, gen,
                  map_axis: Optional[int] = None, map_idx=None):
    """Reset E envs at poses (E, A, 3) -> (state, obs, reward, done, info).

    ``map_idx`` (E,) assigns each env a map of map-stacked params;
    ``map_axis=0`` means the params' maps carry a leading env axis."""
    maps = _env_maps(params, map_axis, poses.shape[0], poses.device)
    if maps is None:
        return reset(cfg, params, poses, gen, map_idx=map_idx)
    if map_idx is not None:
        raise ValueError("pass map_idx or map_axis, not both")
    check_map_idx(params, maps)
    state, *rest = reset_unchecked(cfg, params, poses, gen, maps)
    return (state._replace(map_idx=None), *rest)


def batched_step(cfg: SimConfig, params: EnvParams, states, actions, gen,
                 map_axis: Optional[int] = None):
    """Step E envs: actions (E, A, 2); ``map_axis`` as in batched_reset."""
    maps = _env_maps(params, map_axis, states.x.shape[0], states.x.device)
    if maps is None:
        return step(cfg, params, states, actions, gen)
    state, *rest = step(cfg, params, states._replace(map_idx=maps), actions, gen)
    return (state._replace(map_idx=None), *rest)


class RolloutCarry(NamedTuple):
    state: EnvState   # batched (E, ...)
    obs: Observation  # batched


def _select(new: NamedTuple, old: NamedTuple, idx) -> NamedTuple:
    """``old`` with the rows ``idx`` of every field replaced by ``new``
    (whose rows are exactly those envs), NamedTuple fields field by field;
    a field that is None stays None."""
    fields = []
    for a, b in zip(new, old):
        if isinstance(b, tuple):
            b = _select(a, b, idx)
        elif b is not None:
            b = b.clone()
            b[idx] = a
        fields.append(b)
    return type(old)(*fields)


def reset_done(cfg: SimConfig, params: EnvParams, state: EnvState, obs: Observation,
               done, gen: torch.Generator, randomize_starts=None):
    """Restart the done envs of a step -> (state, obs, reset_any).

    Each env with ``done`` restarts from its start pose on its map (one
    zero-action step, as ``reset``); only those envs are stepped, the others
    keep ``state`` and ``obs``.  ``reset_any`` says whether any env restarted.
    ``randomize_starts`` (M, A, 3) on map-stacked envs: each done env draws
    its next map m uniformly from ``gen``, in env order, and restarts at
    ``randomize_starts[m]``.  Under ``map_axis=0`` the caller passes the
    state with its ``map_idx`` set to ``arange(E)``, as for the step.  Reads
    ``done`` on the host (``torch.nonzero``).

    Inside ``parallel.draws.row_draws`` (a rank's rows of a process
    group's envs) the done envs of every rank are counted, the reset draws
    are made for all of them and this rank keeps its own; a rank with none
    still makes them, and ``reset_any`` says whether any rank restarted.

    Spans: ``rollout/done_read`` (the host read) and ``rollout/restart``
    (the draws and the re-run of the done envs); the counter
    ``rollout/restarted_envs`` adds this process's done envs."""
    with span("rollout/done_read"):
        idx = torch.nonzero(done).squeeze(1)
    shard = draws.current()
    n_local = idx.numel()
    count("rollout/restarted_envs", n_local)
    n_all, before = ((n_local, 0) if shard is None
                     else draws.count_rows(n_local, shard.group))
    if not n_all:
        return state, obs, False
    with span("rollout/restart"):
        with (contextlib.nullcontext() if shard is None
              else draws.row_draws(n_all, before, shard.group)):
            new_maps = None if state.map_idx is None else state.map_idx[idx]
            if randomize_starts is not None:
                new_maps = draws.draw_rows(n_local, lambda n: torch.randint(
                    0, randomize_starts.shape[0], (n,), generator=gen,
                    device=idx.device, dtype=torch.int32))
            if not n_local:
                skip_step_draws(cfg, params, gen)
                return state, obs, True
            poses = (state.start_pose[idx] if randomize_starts is None
                     else randomize_starts[new_maps])
            r_state, r_obs, *_ = reset_unchecked(cfg, params, poses, gen, new_maps)
        return _select(r_state, state, idx), _select(r_obs, obs, idx), True


def make_rollout(cfg: SimConfig, params: EnvParams,
                 policy: Callable[[Observation, torch.Generator], torch.Tensor],
                 steps: int, map_axis: Optional[int] = None,
                 auto_reset: bool = True, collect: bool = False,
                 randomize_starts=None):
    """Build ``run(carry, gen) -> (carry, outs)`` over ``steps`` steps.

    ``policy(obs, gen) -> actions (E, A, 2)``.  With ``auto_reset`` (the
    default), a done env restarts from its start pose on its map (one
    zero-action step, as ``reset``); only the done envs are re-stepped
    (``reset_done``, which ``agents.ppo.PPO.collect`` shares).
    ``outs`` holds the per-step ``reward`` and ``done``, stacked (steps, E),
    ``resets``, the number of steps that reset some env, and with
    ``collect`` the per-step observations ``obs``, an Observation of
    (steps, E, ...) fields (after the step's resets, as in JAX).
    ``map_axis`` is batched_reset's.

    ``randomize_starts`` (M, A, 3), for envs with ``map_idx`` on M stacked
    maps: each done env draws its next map m uniformly from ``gen`` and
    restarts at ``randomize_starts[m]`` on map m.  Without ``map_idx``
    envs ``run`` raises ValueError (JAX asserts alike).

    Random streams.  The JAX package draws a map for every env from a
    split key and keeps the done envs' draws; here only the done envs
    draw, in env order, from ``gen``; in both each done env's map is
    uniform on the M maps.  Under ``noise_mode="pool_rot"`` with the
    megakernel a step call draws one offset off, uniform on the multiples
    of 16 in [0, rows), and env g of the batch passed in reads pool row
    (g + off) % rows: uniform over the rows / 16 rows of its class g mod
    16, the call's rows distinct for no more envs than rows.  The reset
    step passes only the done envs, so the j-th of them reads row
    (j + off') % rows with a fresh offset off' of its own, uniform over
    the class j mod 16.  The JAX package re-steps every env and keeps the
    done ones, so there done env g reads (g + off') % rows, uniform over
    the class g mod 16.  So a done env's class of rows differs from JAX's;
    the law of a batch does not: maps uniform, one offset a call uniform
    on the multiples of 16, rows distinct within a call
    (``tests/test_torch_draws.py``; ``chip_smoke.py [draws]`` on the
    card)."""
    if randomize_starts is not None:
        if map_axis is not None:
            raise ValueError("randomize_starts needs map_idx envs, not map_axis")
        randomize_starts = torch.as_tensor(randomize_starts, dtype=cfg.tdtype,
                                           device=params.tables.cosines.device)
        m_n = params.tmap.dt.shape[0] if params.tmap.dt.dim() == 3 else 0
        if randomize_starts.shape != (m_n, cfg.num_agents, 3):
            raise ValueError(f"randomize_starts must be (M, A, 3) = ({m_n}, "
                             f"{cfg.num_agents}, 3) for these params, got "
                             f"{tuple(randomize_starts.shape)}")

    def run(carry: RolloutCarry, gen: torch.Generator):
        rewards, dones, observations, resets = [], [], [], 0
        state, obs = carry
        if randomize_starts is not None and state.map_idx is None:
            raise ValueError("randomize_starts needs map_idx envs "
                             "(env.make_multimap_params, reset(map_idx=...))")
        maps = _env_maps(params, map_axis, state.x.shape[0], state.x.device)
        for _ in range(steps):
            actions = policy(obs, gen)
            if maps is not None:
                state = state._replace(map_idx=maps)
            state, obs, reward, done, _ = step(cfg, params, state, actions, gen)
            if auto_reset:
                state, obs, reset_any = reset_done(cfg, params, state, obs, done, gen,
                                                   randomize_starts)
                resets += reset_any
            if maps is not None:
                state = state._replace(map_idx=None)
            rewards.append(reward)
            dones.append(done)
            if collect:
                observations.append(obs)
        outs = {"reward": torch.stack(rewards), "done": torch.stack(dones),
                "resets": resets}
        if collect:
            outs["obs"] = Observation(*(torch.stack(f) for f in zip(*observations)))
        return RolloutCarry(state, obs), outs

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
