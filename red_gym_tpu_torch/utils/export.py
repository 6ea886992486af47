"""Policy deployment: ahead-of-time exported inference programs (``.pt2``).

PyTorch counterpart of ``red_gym_tpu/utils/export.py``.  The reference's
deployment story ends at ``torch.save(actor.state_dict(), "sac_actor.pth")``
(reference src/SAL.py:1017): loading that file needs the exact Python model
class.  Here the policy FUNCTION is exported: the greedy head with its
trained weights inside is traced by ``torch.export`` into an
``ExportedProgram`` and saved with ``torch.export.save``.  A ``.pt2`` file
carries

- the traced graph of ATen operators (no Python model code, no pickle of a
  module class): it loads and runs with torch alone, no
  ``red_gym_tpu_torch`` imported;
- the weights, as the program's parameters, on the device the program was
  exported on (where JAX's artifact names the platforms it was lowered for,
  a ``.pt2`` names the device of its weights: export on the device it will
  serve on, or move the loaded module with ``.to(device)``; the graph bakes
  in no device of its own);
- the input specs, with one symbolic batch size shared by every argument's
  leading axis, so one artifact drives a single car or a fleet.

Typical flow::

    fn = deterministic_ppo_control(policy, pcfg)          # weights inside
    save_policy("racer.pt2", fn, (scan[None], vel[None]), device="cuda")
    ...on the robot / server...
    racer = load_policy("racer.pt2").module()
    controls = racer(scans, vels)                          # any batch size
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from red_gym_tpu_torch.agents import ppo as _ppo
from red_gym_tpu_torch.config import resolve_device


class PPOControl(nn.Module):
    """Greedy inference head of a trained ``ScanPolicy``: (scan, vel) ->
    (steer, speed) float32, the mean action squashed exactly as training
    squashed it (``agents.ppo.action_to_control``)."""

    def __init__(self, policy: nn.Module, pcfg: _ppo.PPOConfig):
        super().__init__()
        self.policy = policy
        self.max_steer, self.max_speed = float(pcfg.max_steer), float(pcfg.max_speed)

    def forward(self, scan, vel):
        mean, _, _ = self.policy(scan, vel)
        pcfg = _ppo.PPOConfig(max_steer=self.max_steer, max_speed=self.max_speed)
        return _ppo.action_to_control(mean, pcfg, torch.float32)


class SACAction(nn.Module):
    """Greedy inference head of a trained SAC actor: obs -> tanh(mean) in
    [-1, 1]^A (the evaluation-time action of the tanh-Gaussian policy,
    reference src/SAL.py:414-421 with the noise dropped)."""

    def __init__(self, actor: nn.Module):
        super().__init__()
        self.actor = actor

    def forward(self, obs):
        mean, _ = self.actor(obs)
        return torch.tanh(mean)


def deterministic_ppo_control(policy: nn.Module, pcfg: _ppo.PPOConfig) -> nn.Module:
    """The greedy PPO head as a module of its own, with a copy of the
    policy's weights (later training does not change it), in eval mode."""
    return PPOControl(copy.deepcopy(policy), pcfg).eval()


def deterministic_sac_action(actor: nn.Module) -> nn.Module:
    """The greedy SAC head as a module of its own, with a copy of the
    actor's weights, in eval mode."""
    return SACAction(copy.deepcopy(actor)).eval()


def export_policy(fn: nn.Module, example_args, *, batch: str | None = "b",
                  device="cuda") -> torch.export.ExportedProgram:
    """Export ``fn`` (weights inside) on ``device`` (the card unless the
    caller passes "cpu") with ``torch.export.export``.

    ``example_args`` fixes every trailing dimension and dtype.  With
    ``batch`` set, each argument's leading dimension becomes one shared
    symbolic size (``torch.export.Dim(batch)``), so the program accepts any
    batch of at least 1; per-item scalars (vel ``(N,)``) stay rank 1.  The
    trace runs on a batch of 2 made from the examples' first rows, since
    torch.export fixes a dimension traced at size 1.  With ``batch=None``
    the shapes are the examples' own."""
    device = resolve_device(device)
    fn = fn.to(device).eval()
    args = tuple(torch.as_tensor(a).to(device) for a in example_args)
    dynamic_shapes = None
    if batch:
        args = tuple(a[:1].repeat((2,) + (1,) * (a.dim() - 1)) for a in args)
        dim = torch.export.Dim(batch)
        dynamic_shapes = tuple({0: dim} for _ in args)
    with torch.no_grad():
        return torch.export.export(fn, args, dynamic_shapes=dynamic_shapes)


def save_policy(path, fn: nn.Module, example_args, **kwargs) -> torch.export.ExportedProgram:
    """Export ``fn`` (:func:`export_policy`, same keywords) and write the
    program to ``path`` (``torch.export.save``).  Returns the program
    (``.module()`` runs it at once)."""
    ep = export_policy(fn, example_args, **kwargs)
    torch.export.save(ep, path)
    return ep


def load_policy(path) -> torch.export.ExportedProgram:
    """Load a saved program (``torch.export.load``).  ``.module()`` is the
    callable, on the device it was exported on (``.to(device)`` moves it);
    ``.graph_signature`` and ``.range_constraints`` describe its inputs."""
    return torch.export.load(path)
