"""red_gym_tpu_torch: the F1TENTH simulator of ``red_gym_tpu`` in PyTorch.

The port runs on an NVIDIA GPU (hand-written CUDA kernels for Hopper,
``csrc/``) and on the CPU (their plain PyTorch twins).  It mirrors the JAX
package's module layout and names, imports ``torch`` and never ``jax``,
and imports nothing from ``red_gym_tpu``.

Entry points: ``env.make_params`` / ``env.step`` / ``env.reset``,
``rollout.batched_reset`` / ``rollout.make_rollout``, and the gym-style
``env.F110Env``.
"""

from red_gym_tpu_torch.config import Integrator, SimConfig, VehicleParams

__all__ = ["Integrator", "SimConfig", "VehicleParams"]
