"""Stateful vectorized env: thousands of F110 envs, one object.

PyTorch counterpart of ``red_gym_tpu/vec_env.py``.  It packages the batched
functions of ``env`` and ``rollout`` as the familiar VecEnv shape (reset and
step with batched tensors, auto-reset on done) for users of the reference
gym API who do not adopt the functional style.  The state stays on the
device and the step returns torch tensors there; ``numpy_step`` is the host
boundary that the gymnasium vector facade (``gym_vector``) crosses every
step.
"""

from __future__ import annotations

import numpy as np
import torch

from red_gym_tpu_torch import env as envlib
from red_gym_tpu_torch.config import Integrator, SimConfig, VehicleParams, resolve_device
from red_gym_tpu_torch.rollout import reset_done


def _yaml(m: str) -> str:
    return m if m.endswith(".yaml") else f"{m}.yaml"


class VecF110Env:
    """Batched stateful env.

    obs, reward and done come back as batched tensors on the env's device;
    crashed or finished envs restart at their start pose within the same
    step (``rollout.reset_done``, the reset recipe that ``make_rollout`` and
    ``agents.ppo.PPO.collect`` share), and the info dict carries the
    pre-reset ``done`` flags.  Randomness comes from one ``torch.Generator``
    seeded with ``seed`` (``self.gen``)."""

    def __init__(self, map: str | list[str], num_envs: int,
                 map_ext: str = ".png", num_agents: int = 2,
                 timestep: float = 0.01,
                 integrator: Integrator = Integrator.RK4,
                 seed: int = 12345, auto_reset: bool = True,
                 params: dict | VehicleParams | None = None,
                 map_idx=None, randomize_starts=None,
                 return_final_obs: bool = False, device="cuda", **cfg_kwargs):
        """``map``: a map yaml path (with or without ".yaml"), or a list of
        them for a multi-map batch, env e on map ``map_idx[e]`` (default
        e % M).

        ``randomize_starts``: optional (M, A, 3) per-map start-pose table
        for a multi-map batch: every auto-reset draws a track uniformly from
        ``self.gen`` and spawns at that track's start pose.

        ``return_final_obs``: also return the step's pre-reset observation
        in ``info["final_obs"]`` (the gymnasium same-step autoreset
        convention: bootstrapping at episode ends needs the terminal obs).

        Every other keyword is a SimConfig field; an unknown one raises
        TypeError.  The env runs on ``device``, the card unless the caller
        passes "cpu"."""
        unknown = set(cfg_kwargs) - set(SimConfig.__dataclass_fields__)
        if unknown:
            raise TypeError(f"unknown SimConfig option(s): {sorted(unknown)}")
        self.device = resolve_device(device)
        self.num_envs = num_envs
        self.auto_reset = auto_reset
        self.return_final_obs = return_final_obs
        self.cfg = SimConfig(num_agents=num_agents, timestep=timestep,
                             integrator=integrator, **cfg_kwargs)
        if isinstance(params, dict):
            vehicle = VehicleParams.from_dict(params, self.cfg.tdtype, self.device)
        elif isinstance(params, VehicleParams):
            vehicle = params
        else:
            vehicle = VehicleParams.default(self.cfg.tdtype, self.device)

        if isinstance(map, (list, tuple)):
            self.params = envlib.make_multimap_params(
                self.cfg, [_yaml(m) for m in map], map_ext, vehicle, device=self.device)
            if map_idx is None:
                map_idx = np.arange(num_envs) % len(map)
            self._map_idx = torch.as_tensor(np.asarray(map_idx), device=self.device
                                            ).to(torch.int32)
        else:
            self.params = envlib.make_params(self.cfg, _yaml(map), map_ext, vehicle,
                                             device=self.device)
            self._map_idx = None
        if randomize_starts is not None:
            if self._map_idx is None:
                raise ValueError("randomize_starts needs a multi-map env "
                                 "(pass a list of maps)")
            randomize_starts = torch.as_tensor(np.asarray(randomize_starts),
                                               dtype=self.cfg.tdtype, device=self.device)
            if randomize_starts.shape[0] != len(map):
                raise ValueError(
                    f"randomize_starts has {randomize_starts.shape[0]} rows "
                    f"for {len(map)} maps")
        self._randomize_starts = randomize_starts
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.states: envlib.EnvState | None = None

    def reset(self, poses):
        """poses (E, A, 3), or (A, 3) for every env -> (obs dict, reward (E,),
        done (E,), info)."""
        poses = torch.as_tensor(poses, dtype=self.cfg.tdtype, device=self.device)
        if poses.dim() == 2:
            poses = poses.expand((self.num_envs,) + tuple(poses.shape))
        self.states, obs, reward, done, info = envlib.reset(
            self.cfg, self.params, poses, self.gen, map_idx=self._map_idx)
        return self._obs_dict(obs), reward, done, self._info(info, done)

    def step(self, actions):
        """actions (E, A, 2) -> (obs dict, reward (E,), done (E,), info)."""
        actions = torch.as_tensor(actions, dtype=self.cfg.tdtype, device=self.device)
        state, obs, reward, done, info = envlib.step(self.cfg, self.params, self.states,
                                                     actions, self.gen)
        out = self._info(info, done)
        if self.return_final_obs:
            out["final_obs"] = self._obs_dict(obs)
        if self.auto_reset:
            state, obs, _ = reset_done(self.cfg, self.params, state, obs, done, self.gen,
                                       self._randomize_starts)
        self.states = state
        return self._obs_dict(obs), reward, done, out

    def _obs_dict(self, obs: envlib.Observation) -> dict:
        d = obs._asdict()
        d["ego_idx"] = self.cfg.ego_idx
        return d

    @staticmethod
    def _info(info, done) -> dict:
        return {"checkpoint_done": info["checkpoint_done"], "done": done}


def numpy_obs(obs: dict) -> dict:
    """A batched obs dict on the host: every field a float32 numpy array,
    without ``ego_idx`` (the gymnasium facades' observation)."""
    return {k: v.cpu().numpy().astype(np.float32, copy=False) for k, v in obs.items()
            if k != "ego_idx"}


def numpy_step(obs: dict, reward, done, info: dict):
    """One VecF110Env step's results on the host, in the gymnasium vector
    API's form -> (obs, reward (E,) float32, terminated (E,) bool, truncated
    (E,) bool, infos): ``infos`` holds ``checkpoint_done`` and, where the
    step returned it, the terminal observation ``final_obs`` with its
    presence mask ``_final_obs`` (same-step autoreset).  Each call copies
    the observations from the device: the wrapper's cost over the tensors
    that VecF110Env returns."""
    term = done.cpu().numpy().astype(bool)
    infos = {"checkpoint_done": info["checkpoint_done"].cpu().numpy()}
    if "final_obs" in info:
        infos["final_obs"] = numpy_obs(info["final_obs"])
        infos["_final_obs"] = term.copy()
    return (numpy_obs(obs), reward.cpu().numpy().astype(np.float32), term,
            np.zeros_like(term), infos)
