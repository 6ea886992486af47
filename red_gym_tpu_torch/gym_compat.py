"""Drop-in ``gym`` shim for reference scripts.

PyTorch counterpart of ``red_gym_tpu/gym_compat.py``.  The reference's
examples do::

    import gym
    env = gym.make('f110_gym:f110-v0', map=..., map_ext=..., num_agents=1,
                   timestep=0.01, integrator=Integrator.RK4)
    obs, step_reward, done, _ = env.reset(poses)      # classic 4-tuple
    obs, step_reward, done, info = env.step(action)

(reference: examples/waypoint_follow.py:272-287).  Porting such a script to
the port is one line::

    from red_gym_tpu_torch import gym_compat as gym

``make`` maps the reference env ids to :class:`red_gym_tpu_torch.env.F110Env`
(the classic gym==0.19 API, with the fork's reset-returns-4-tuple quirk,
f110_env.py:304-347) and goes through no registry.  It runs on the card
unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

from red_gym_tpu_torch.env import F110Env

_F110_IDS = {"f110_gym:f110-v0", "f110-v0"}


def make(id: str, **kwargs) -> F110Env:
    if id not in _F110_IDS:
        raise ValueError(
            f"unknown env id {id!r}: this shim serves {sorted(_F110_IDS)}")
    return F110Env(**kwargs)
