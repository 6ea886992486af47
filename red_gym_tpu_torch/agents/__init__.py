"""Agents: the pure-pursuit planner and the PPO actor-learner
(``red_gym_tpu/agents/`` counterparts)."""
