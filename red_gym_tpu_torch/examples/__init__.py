"""Runnable examples: ``python -m red_gym_tpu_torch.examples.<name>``."""
