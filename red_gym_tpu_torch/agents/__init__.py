"""Agents: the pure-pursuit planner, the PPO actor-learner, the batched MPC,
the planning env and SAC (``red_gym_tpu/agents/`` counterparts)."""
