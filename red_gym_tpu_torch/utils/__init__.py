"""Utilities: checkpoints (``red_gym_tpu/utils/`` counterparts)."""
