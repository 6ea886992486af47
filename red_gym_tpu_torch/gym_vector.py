"""Gymnasium ``VectorEnv`` adapter over the on-device env batch.

PyTorch counterpart of ``red_gym_tpu/gym_vector.py``.  The batch lives on
one card (:class:`red_gym_tpu_torch.vec_env.VecF110Env`), and this module
exposes it through the standard ``gymnasium.vector.VectorEnv`` interface so
that vector-API tooling drives thousands of cars unchanged:

    import gymnasium
    import red_gym_tpu_torch           # registers red_gym_tpu_torch/f110-v0
    envs = gymnasium.make_vec("red_gym_tpu_torch/f110-v0", num_envs=1024,
                              map="...", map_ext=".png")
    obs, info = envs.reset()
    obs, rew, term, trunc, info = envs.step(actions)   # (E, A, 2) numpy

Autoreset follows the SAME_STEP convention: a terminated env returns its
fresh reset observation in the same step, with the terminal observation in
``info["final_obs"]`` (stacked arrays) masked by ``info["_final_obs"]``.

The numpy boundary copies every observation from the device at every step
(``vec_env.numpy_step``); training at speed should use
:mod:`red_gym_tpu_torch.rollout` or :class:`VecF110Env` directly, which keep
the observations on the device.
"""

from __future__ import annotations

import numpy as np

from gymnasium.vector import AutoresetMode, VectorEnv
from gymnasium.vector.utils import batch_space

from red_gym_tpu_torch.env import staggered_start_poses
from red_gym_tpu_torch.gym_adapter import action_space_box, single_obs_space
from red_gym_tpu_torch.vec_env import VecF110Env, numpy_obs, numpy_step


class F110VectorEnv(VectorEnv):
    """``gymnasium.vector.VectorEnv`` facade over :class:`VecF110Env`.

    The constructor kwargs are VecF110Env's (map, map_ext, num_agents,
    timestep, params, a list of maps, ``randomize_starts``, every SimConfig
    field, ``device``).  ``reset`` takes start poses through
    ``options={"poses": ...}`` ((A, 3) for every env, or (E, A, 3)); without
    them the agents spawn staggered behind the reference's example start
    pose.  ``reset(seed=...)`` reseeds the batch's generator.
    """

    metadata = {"autoreset_mode": AutoresetMode.SAME_STEP}

    def __init__(self, num_envs: int, **kwargs):
        self.render_mode = None
        self.num_envs = int(num_envs)
        self.vec = VecF110Env(num_envs=self.num_envs, return_final_obs=True, **kwargs)
        cfg = self.vec.cfg
        self.single_action_space = action_space_box(self.vec.params.vehicle,
                                                    cfg.num_agents)
        self.single_observation_space = single_obs_space(cfg.num_agents, cfg.num_beams)
        self.action_space = batch_space(self.single_action_space, self.num_envs)
        self.observation_space = batch_space(self.single_observation_space,
                                             self.num_envs)

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self.vec.gen.manual_seed(seed)
        poses = None if options is None else options.get("poses")
        if poses is None:
            poses = staggered_start_poses(self.vec.cfg.num_agents)
        obs, _reward, _done, _info = self.vec.reset(np.asarray(poses))
        return numpy_obs(obs), {}

    def step(self, actions):
        return numpy_step(*self.vec.step(np.asarray(actions)))

    def render(self):
        return None

    def close_extras(self, **kwargs):
        pass
