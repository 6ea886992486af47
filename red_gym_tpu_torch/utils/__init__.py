"""Utilities: checkpoints, state health checks and profiling
(``red_gym_tpu/utils/`` counterparts)."""
