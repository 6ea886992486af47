"""red_gym_tpu_torch: the F1TENTH simulator of ``red_gym_tpu`` in PyTorch.

The port runs on an NVIDIA GPU (hand-written CUDA kernels for Hopper,
``csrc/``) and on the CPU (their plain PyTorch twins).  It mirrors the JAX
package's module layout and names, imports ``torch`` and never ``jax``,
and imports nothing from ``red_gym_tpu``.

Entry points: ``env.make_params`` / ``env.step`` / ``env.reset``,
``rollout.batched_reset`` / ``rollout.make_rollout``, the gym-style
``env.F110Env`` (``make``) and the batched ``vec_env.VecF110Env``
(``make_vec``), ``gym_compat.make`` for reference scripts, and, where
gymnasium is installed, the id ``red_gym_tpu_torch/f110-v0`` for
``gymnasium.make`` / ``gymnasium.make_vec`` (``gym_adapter``,
``gym_vector``).  Importing the package loads none of the env modules and
builds no kernel.
"""

from red_gym_tpu_torch.config import Integrator, SimConfig, VehicleParams

__all__ = ["Integrator", "SimConfig", "VehicleParams", "make", "make_vec"]


def make(map, **kwargs):
    """Single stateful env with the reference gym API (see env.F110Env)."""
    from red_gym_tpu_torch import env as _env

    return _env.make(map, **kwargs)


def make_vec(map, num_envs, **kwargs):
    """Batched stateful env (see vec_env.VecF110Env)."""
    from red_gym_tpu_torch.vec_env import VecF110Env

    return VecF110Env(map, num_envs, **kwargs)


# register 'red_gym_tpu_torch/f110-v0' with gymnasium where it is installed;
# _registration imports only gymnasium, so the adapter loads at first make()
try:
    from red_gym_tpu_torch import _registration as _reg

    _reg.register()
except ImportError:  # gymnasium not installed: the facades are optional
    pass
