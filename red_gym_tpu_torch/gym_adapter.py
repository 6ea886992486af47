"""Gymnasium adapter and registration.

PyTorch counterpart of ``red_gym_tpu/gym_adapter.py``.  The reference is a
classic OpenAI-Gym env registered as ``f110_gym:f110-v0`` (reference:
gym/f110_gym/__init__.py:1-5, envs/f110_env.py:53) with the gym==0.19
4-tuple API.  This module is the modern form:

* :class:`F110GymnasiumEnv`, a ``gymnasium.Env`` (5-tuple step,
  ``reset(seed=..., options={"poses": ...})``) registered as
  ``red_gym_tpu_torch/f110-v0`` on package import (``_registration``);
* reference scripts use :mod:`red_gym_tpu_torch.gym_compat` instead.

Observations are float32 numpy arrays on the host, as in JAX.
"""

from __future__ import annotations

import numpy as np

import gymnasium
from gymnasium import spaces

from red_gym_tpu_torch.env import F110Env, action_bounds, staggered_start_poses


def single_obs_space(a: int, b: int) -> spaces.Dict:
    """Per-env observation space (A agents, B beams), shared by the
    single-env and vector adapters."""
    inf = np.inf
    return spaces.Dict({
        # gaussian beam noise is added after the max-range clamp
        # (reference laser_models.py:450-452), so scans are unbounded
        "scans": spaces.Box(-inf, inf, (a, b), np.float32),
        "poses_x": spaces.Box(-inf, inf, (a,), np.float32),
        "poses_y": spaces.Box(-inf, inf, (a,), np.float32),
        "poses_theta": spaces.Box(-inf, inf, (a,), np.float32),
        "linear_vels_x": spaces.Box(-inf, inf, (a,), np.float32),
        "linear_vels_y": spaces.Box(-inf, inf, (a,), np.float32),
        "ang_vels_z": spaces.Box(-inf, inf, (a,), np.float32),
        "collisions": spaces.Box(0.0, 1.0, (a,), np.float32),
        "lap_times": spaces.Box(0.0, inf, (a,), np.float32),
        "lap_counts": spaces.Box(0.0, inf, (a,), np.float32),
    })


def action_space_box(vehicle, a: int) -> spaces.Box:
    """Per-env (A, 2) steer/speed action box from the vehicle limits."""
    lo, hi = action_bounds(vehicle)
    return spaces.Box(low=np.tile(lo, (a, 1)), high=np.tile(hi, (a, 1)),
                      dtype=np.float32)


class F110GymnasiumEnv(gymnasium.Env):
    """``gymnasium.Env`` facade over :class:`red_gym_tpu_torch.env.F110Env`.

    Takes the reference env's constructor kwargs (map, map_ext, params,
    num_agents, timestep, ego_idx, integrator, fov, seed, every SimConfig
    field) and ``device`` (the card unless "cpu").  ``reset`` takes the
    (num_agents, 3) start poses through ``options={"poses": ...}``; without
    them the agents spawn staggered behind the reference's example start
    pose (``env.staggered_start_poses``).
    """

    metadata = {"render_modes": ["human", "human_fast", "rgb_array"]}

    def __init__(self, render_mode: str | None = None, **kwargs):
        self.render_mode = render_mode
        self.env = F110Env(**kwargs)
        cfg = self.env.cfg
        self.action_space = action_space_box(self.env.params.vehicle, cfg.num_agents)
        self.observation_space = single_obs_space(cfg.num_agents, cfg.num_beams)

    @staticmethod
    def _obs(legacy: dict) -> dict:
        return {k: np.asarray(v, np.float32) for k, v in legacy.items()
                if k != "ego_idx"}

    def reset(self, *, seed=None, options=None):
        super().reset(seed=seed)
        if seed is not None:
            self.env.seed = seed
        poses = None if options is None else options.get("poses")
        if poses is None:
            poses = staggered_start_poses(self.env.cfg.num_agents)
        obs, _reward, _done, info = self.env.reset(np.asarray(poses))
        return self._obs(obs), info

    def step(self, action):
        obs, reward, done, info = self.env.step(np.asarray(action))
        # the reference's done = ego collision or all agents finished
        # (f110_env.py:202-244); no time-limit truncation is built in
        return self._obs(obs), float(reward), bool(done), False, info

    def render(self):
        if self.render_mode in ("human", "human_fast"):
            self.env.render(mode=self.render_mode)
            return None
        if self.render_mode == "rgb_array":
            self.env.render(mode="human_fast")
            fig = self.env._renderer.fig
            fig.canvas.draw()
            return np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
        return None

    def add_render_callback(self, fn):
        self.env.add_render_callback(fn)

    def close(self):
        if self.env._renderer is not None:
            self.env._renderer.close()
            self.env._renderer = None


def register():
    """Idempotently register ``red_gym_tpu_torch/f110-v0`` with gymnasium
    (delegates to :mod:`red_gym_tpu_torch._registration`, the import-light
    module that the package's ``__init__`` uses)."""
    from red_gym_tpu_torch import _registration

    _registration.register()
