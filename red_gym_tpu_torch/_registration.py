"""Gymnasium id registration, kept free of heavy imports.

``import red_gym_tpu_torch`` must stay cheap, so registering the port's
gymnasium id goes through this module, which imports only gymnasium: the
entry points are strings that gymnasium resolves at ``make()`` time, so the
adapter (and with it the env and its kernels) loads on first use.

The id is namespaced, ``red_gym_tpu_torch/f110-v0``.  The JAX package
registers the plain ``f110-v0`` (the reference's gym id), and both packages
can be imported in one process: with one shared id, whichever imported
first would serve both.  Reference scripts keep the plain ids through
``red_gym_tpu_torch.gym_compat``.
"""

ENV_ID = "red_gym_tpu_torch/f110-v0"


def register():
    """Idempotently register ``red_gym_tpu_torch/f110-v0`` with gymnasium;
    its vector entry point serves ``gymnasium.make_vec(ENV_ID,
    num_envs=...)`` with the on-device batch (``gym_vector``).  Raises
    ImportError when gymnasium is not installed."""
    import gymnasium

    if ENV_ID not in gymnasium.registry:
        try:
            gymnasium.register(
                id=ENV_ID,
                entry_point="red_gym_tpu_torch.gym_adapter:F110GymnasiumEnv",
                vector_entry_point="red_gym_tpu_torch.gym_vector:F110VectorEnv")
        except TypeError:
            # gymnasium < 1.0 has no vector_entry_point kwarg; register
            # the single-env entry point so that plain make() still works
            gymnasium.register(
                id=ENV_ID,
                entry_point="red_gym_tpu_torch.gym_adapter:F110GymnasiumEnv")
