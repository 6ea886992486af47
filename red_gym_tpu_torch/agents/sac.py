"""Soft Actor-Critic over lidar bitmaps or scans.

PyTorch counterpart of ``red_gym_tpu/agents/sac.py`` (reference:
src/SAL.py:390-580): the same CNN actor (3 conv -> fc -> tanh-squashed
diagonal Gaussian), twin CNN critics and soft target updates, and the scan
MLP modules of the at-scale trainer.  The replay buffer lives on the device
as a fixed-size ring of tensors, written in place (at the bitmap trainer's
25,000 transitions of 256 x 256 bytes it holds 3.3 GB).

Layout and types follow flax's: the trunk convolves (B, 1, H, W) and
flattens in (H, W, C) order, so a flax kernel tree carries across
(``interop.sac_from_numpy``).  Parameters are float32 master weights; the
conv trunk and the 512-wide layer compute in ``compute_dtype`` (bfloat16
by default), the heads in float32 (or in ``compute_dtype`` where that is
wider: a float64 network is float64 throughout).

State.  ``SACState`` holds the modules and their ``torch.optim.Adam``
(optax.adam's arithmetic); ``SAC.update`` changes them in place and returns
the same state.  Randomness comes from a ``torch.Generator``, or is passed
in (``noise``) so that tests can hand both packages the same draws.

Hyperparameters match SAL.py:478-497: gamma 0.99, tau 0.005, alpha 0.2,
lr 3e-4 for actor and critics, batch 64, log_std clamped to [-20, 2].
"""

from __future__ import annotations

import copy
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from red_gym_tpu_torch.agents.ppo import lecun_normal_
from red_gym_tpu_torch.config import resolve_device

_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


def _head_dtype(compute_dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(torch.float32, compute_dtype)


def _dense(lin: nn.Linear, x, dtype):
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


def _reset(module: nn.Module, gen: torch.Generator | None) -> None:
    """flax's initialisation of every Linear and Conv2d of ``module``, in
    registration order: lecun_normal kernels, zero biases."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            lecun_normal_(m.weight, gen)
            nn.init.zeros_(m.bias)


class ConvTrunk(nn.Module):
    """The SAL CNN feature stack (SAL.py:397-400): 8x8/4, 4x4/2, 3x3/1,
    VALID padding, 16, 32, 32 channels."""

    def __init__(self, compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv_0 = nn.Conv2d(1, 16, 8, stride=4)
        self.conv_1 = nn.Conv2d(16, 32, 4, stride=2)
        self.conv_2 = nn.Conv2d(32, 32, 3, stride=1)

    @staticmethod
    def features(obs_shape) -> int:
        """Flattened feature count for (H, W) inputs: 25,088 at 256 x 256."""
        h, w = obs_shape
        for k, s in ((8, 4), (4, 2), (3, 1)):
            h, w = (h - k) // s + 1, (w - k) // s + 1
        return h * w * 32

    def forward(self, x):
        """x (B, H, W) uint8 or float in [0, 255] -> (B, features)."""
        cd = self.compute_dtype
        x = (x.to(cd) / 255.0)[:, None]
        for conv in (self.conv_0, self.conv_1, self.conv_2):
            x = F.relu(F.conv2d(x, conv.weight.to(cd), conv.bias.to(cd), conv.stride))
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class Actor(nn.Module):
    """Tanh-squashed Gaussian policy (SAL.py:390-421)."""

    def __init__(self, obs_shape=(256, 256), action_dim: int = 32,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.trunk = ConvTrunk(compute_dtype)
        self.dense_0 = nn.Linear(ConvTrunk.features(obs_shape), 512)
        self.mean = nn.Linear(512, action_dim)
        self.log_std = nn.Linear(512, action_dim)

    def reset_parameters(self, gen: torch.Generator | None = None) -> None:
        _reset(self, gen)

    def forward(self, x):
        cd, hd = self.compute_dtype, _head_dtype(self.compute_dtype)
        h = F.relu(_dense(self.dense_0, self.trunk(x), cd)).to(hd)
        return (_dense(self.mean, h, hd),
                torch.clamp(_dense(self.log_std, h, hd), -20.0, 2.0))


class Critic(nn.Module):
    """Q(s, a) with the shared trunk shape (SAL.py:423-442)."""

    def __init__(self, obs_shape=(256, 256), action_dim: int = 32,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.trunk = ConvTrunk(compute_dtype)
        self.dense_0 = nn.Linear(ConvTrunk.features(obs_shape) + action_dim, 512)
        self.out = nn.Linear(512, 1)

    def reset_parameters(self, gen: torch.Generator | None = None) -> None:
        _reset(self, gen)

    def forward(self, x, action):
        cd, hd = self.compute_dtype, _head_dtype(self.compute_dtype)
        h = torch.cat([self.trunk(x).to(hd), action.to(hd)], dim=-1)
        h = F.relu(_dense(self.dense_0, h, cd))
        return _dense(self.out, h.to(hd), hd)


class ScanTrunk(nn.Module):
    """MLP features over strided log-compressed lidar ranges — the
    bandwidth-light observation for SAC at scale."""

    def __init__(self, num_beams: int = 1080, hidden: int = 256, stride: int = 8,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.compute_dtype = stride, compute_dtype
        self.dense_0 = nn.Linear((num_beams + stride - 1) // stride, hidden)
        self.dense_1 = nn.Linear(hidden, hidden)

    def forward(self, scan):
        cd = self.compute_dtype
        x = torch.log1p(scan[..., ::self.stride].to(cd))
        x = F.relu(_dense(self.dense_0, x, cd))
        return F.relu(_dense(self.dense_1, x, cd))


class ScanActor(nn.Module):
    """Tanh-squashed Gaussian policy over raw scans (drop-in for Actor)."""

    def __init__(self, num_beams: int = 1080, action_dim: int = 2, hidden: int = 256,
                 stride: int = 8, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.trunk = ScanTrunk(num_beams, hidden, stride, compute_dtype)
        self.mean = nn.Linear(hidden, action_dim)
        self.log_std = nn.Linear(hidden, action_dim)

    def reset_parameters(self, gen: torch.Generator | None = None) -> None:
        _reset(self, gen)

    def forward(self, scan):
        hd = _head_dtype(self.compute_dtype)
        h = self.trunk(scan).to(hd)
        return (_dense(self.mean, h, hd),
                torch.clamp(_dense(self.log_std, h, hd), -20.0, 2.0))


class ScanCritic(nn.Module):
    """Q(scan, a) (drop-in for Critic)."""

    def __init__(self, num_beams: int = 1080, action_dim: int = 2, hidden: int = 256,
                 stride: int = 8, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.trunk = ScanTrunk(num_beams, hidden, stride, compute_dtype)
        self.dense_0 = nn.Linear(hidden + action_dim, hidden)
        self.out = nn.Linear(hidden, 1)

    def reset_parameters(self, gen: torch.Generator | None = None) -> None:
        _reset(self, gen)

    def forward(self, scan, action):
        cd, hd = self.compute_dtype, _head_dtype(self.compute_dtype)
        h = torch.cat([self.trunk(scan).to(hd), action.to(hd)], dim=-1)
        h = F.relu(_dense(self.dense_0, h, cd))
        return _dense(self.out, h.to(hd), hd)


def normal_draw(shape, gen: torch.Generator | None, dtype, device):
    """A standard normal draw of ``shape`` from ``gen``: every draw of SAC's
    (the policy's eps and the update's two) goes through here."""
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def replay_indices(size: int, batch_size: int, gen: torch.Generator, device):
    """``batch_size`` indices uniform on [0, max(size, 1)), drawn from ``gen``:
    the draw of ``ReplayBuffer.sample``."""
    return torch.randint(0, max(size, 1), (batch_size,), generator=gen, device=device)


def sample_action(actor: nn.Module, obs, gen: torch.Generator | None = None,
                  noise=None):
    """rsample + tanh squash with the log-prob correction (SAL.py:414-421)
    -> (action (B, A), log_prob (B, 1)).  The standard normal draw is
    ``noise`` where given, else drawn from ``gen``."""
    return _squash(*actor(obs), gen, noise)


def _squash(mean, log_std, gen, noise):
    """``sample_action`` on the actor's output (mean, log_std)."""
    std = torch.exp(log_std)
    eps = noise if noise is not None else normal_draw(mean.shape, gen, mean.dtype,
                                                      mean.device)
    x_t = mean + std * eps
    y_t = torch.tanh(x_t)
    normal_logp = -0.5 * ((x_t - mean) / std) ** 2 - log_std - _HALF_LOG_2PI
    log_prob = torch.sum(normal_logp - torch.log(1 - y_t**2 + 1e-6), dim=-1, keepdim=True)
    return y_t, log_prob


class ReplayBuffer:
    """On-device ring buffer (the functional ring of the JAX package, written
    in place here; the reference keeps a host deque, SAL.py:447-463).
    ``ptr`` and ``size`` are host integers, so pushing and sampling never
    wait for the device.  Obs dtype follows what ``create`` was given (uint8
    for bitmaps, float for scans)."""

    def __init__(self, obs, action, reward, next_obs, done, ptr: int = 0, size: int = 0):
        self.obs, self.action, self.reward = obs, action, reward
        self.next_obs, self.done = next_obs, done
        self.ptr, self.size = ptr, size

    @classmethod
    def create(cls, capacity: int, obs_shape, action_dim: int,
               obs_dtype=torch.uint8, device="cuda") -> "ReplayBuffer":
        """An empty buffer of ``capacity`` transitions on ``device`` (the
        card unless the caller passes "cpu")."""
        device = resolve_device(device)
        z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device=device)  # noqa: E731
        return cls(obs=z(capacity, *obs_shape, dt=obs_dtype), action=z(capacity, action_dim),
                   reward=z(capacity), next_obs=z(capacity, *obs_shape, dt=obs_dtype),
                   done=z(capacity))

    @property
    def capacity(self) -> int:
        return self.obs.shape[0]

    def push(self, obs, action, reward, next_obs, done) -> "ReplayBuffer":
        """Insert one transition -> the buffer."""
        return self.push_batch(obs[None], action.reshape(1, -1),
                               torch.as_tensor(reward).reshape(1),
                               next_obs[None], torch.as_tensor(done).reshape(1))

    def push_batch(self, obs, action, reward, next_obs, done) -> "ReplayBuffer":
        """Insert a batch of B transitions at (ptr + arange(B)) % capacity,
        wrapping around -> the buffer."""
        c, b = self.capacity, obs.shape[0]
        idx = (self.ptr + torch.arange(b, device=self.obs.device)) % c
        for dst, src in ((self.obs, obs), (self.action, action), (self.reward, reward),
                         (self.next_obs, next_obs), (self.done, done)):
            dst[idx] = src.to(device=dst.device, dtype=dst.dtype)
        self.ptr = (self.ptr + b) % c
        self.size = min(self.size + b, c)
        return self

    def sample(self, gen: torch.Generator, batch_size: int):
        """``batch_size`` transitions drawn uniformly (with replacement) from
        the filled part -> (obs, action, reward, next_obs, done)."""
        idx = replay_indices(self.size, batch_size, gen, self.obs.device)
        return (self.obs[idx], self.action[idx], self.reward[idx],
                self.next_obs[idx], self.done[idx])


# what SAC.update reports beside JAX's three losses, in the trainers' CSV order
UPDATE_DIAGNOSTICS = ("q_mean", "logp_mean", "log_std_mean", "actor_grad_norm",
                      "critic1_grad_norm", "critic2_grad_norm")


class SACState(NamedTuple):
    actor: nn.Module
    critic1: nn.Module
    critic2: nn.Module
    target1: nn.Module
    target2: nn.Module
    actor_opt: torch.optim.Optimizer
    critic1_opt: torch.optim.Optimizer
    critic2_opt: torch.optim.Optimizer


class SAC:
    """SAC trainer with the SAL.py hyperparameters."""

    def __init__(self, obs_shape=(256, 256), action_dim: int = 32,
                 gamma: float = 0.99, tau: float = 0.005, alpha: float = 0.2,
                 actor_lr: float = 3e-4, critic_lr: float = 3e-4,
                 compute_dtype: torch.dtype = torch.bfloat16, actor: nn.Module | None = None,
                 critic: nn.Module | None = None, obs_dtype=torch.uint8,
                 grad_clip: float | None = None, device="cuda"):
        """``grad_clip``: optional global-norm gradient clip, optax's rule
        (scale by grad_clip / norm where the norm is at least grad_clip).
        The reference runs plain Adam (SAL.py:495-497) — None preserves
        that; scaled many-env training benefits from clipping.  The modules
        live on ``device`` (the card unless the caller passes "cpu")."""
        self.device = resolve_device(device)
        self.actor = actor if actor is not None else Actor(obs_shape, action_dim, compute_dtype)
        self.critic = critic if critic is not None else Critic(obs_shape, action_dim,
                                                               compute_dtype)
        self.gamma, self.tau, self.alpha = gamma, tau, alpha
        self.actor_lr, self.critic_lr = actor_lr, critic_lr
        self.grad_clip = grad_clip
        self.obs_shape = tuple(obs_shape)
        self.action_dim = action_dim
        self.obs_dtype = obs_dtype

    def _module(self, template: nn.Module, gen) -> nn.Module:
        m = copy.deepcopy(template)
        m.reset_parameters(gen)
        return m.to(device=self.device, dtype=_head_dtype(m.compute_dtype))

    def _adam(self, module: nn.Module, lr: float) -> torch.optim.Optimizer:
        return torch.optim.Adam(module.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def init(self, gen: torch.Generator) -> SACState:
        """Fresh modules (flax's initialisation, drawn from ``gen``, a CPU
        generator: actor, critic 1, critic 2), targets equal to the critics,
        and their Adams."""
        actor = self._module(self.actor, gen)
        c1, c2 = self._module(self.critic, gen), self._module(self.critic, gen)
        t1, t2 = copy.deepcopy(c1), copy.deepcopy(c2)
        for t in (t1, t2):
            t.requires_grad_(False)
        return SACState(actor, c1, c2, t1, t2, self._adam(actor, self.actor_lr),
                        self._adam(c1, self.critic_lr), self._adam(c2, self.critic_lr))

    @torch.no_grad()
    def select_action(self, state: SACState, obs, gen: torch.Generator | None = None,
                      evaluate: bool = False):
        """Actions for a batch of observations (or one, given without its
        batch axis): the squashed mean with ``evaluate``, else a sample
        drawn from ``gen``."""
        obs = obs[None] if obs.dim() == len(self.obs_shape) else obs
        if evaluate:
            mean, _ = state.actor(obs)
            return torch.tanh(mean)
        return sample_action(state.actor, obs, gen)[0]

    def _clip(self, params) -> None:
        """optax.clip_by_global_norm on the grads of ``params``, in place."""
        if self.grad_clip is None:
            return
        grads = [p.grad for p in params]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        factor = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                             self.grad_clip / norm)
        torch._foreach_mul_(grads, factor)

    def _step(self, module: nn.Module, opt: torch.optim.Optimizer, loss):
        """One optimizer step of ``module`` on ``loss`` -> the global norm of
        its gradient before the clip (0-d)."""
        params = [p for p in module.parameters()]
        grads = torch.autograd.grad(loss, params)
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        for p, g in zip(params, grads):
            p.grad = g
        self._clip(params)
        opt.step()
        opt.zero_grad(set_to_none=True)
        return norm

    def update(self, state: SACState, batch, gen: torch.Generator | None = None,
               noise=None):
        """One SAC update (SAL.py:521-580): twin-critic TD, then the actor on
        the UPDATED critics, then the soft target update toward them.
        ``batch`` = (obs, action, reward, next_obs, done); the two normal
        draws (next action, new action) come from ``gen`` or ``noise`` =
        (eps_next, eps_new).  Updates ``state`` in place -> (state,
        {"actor_loss", "critic1_loss", "critic2_loss"} and the diagnostics
        of ``UPDATE_DIAGNOSTICS``, all 0-d tensors).  The diagnostics read
        what the update computes anyway, draw nothing and change no bit of
        it: the mean over the batch of the twin-Q minimum and of the new
        actions' log-probability (the actor loss's two terms), the mean of
        the actor's log_std, and each network's global gradient norm
        before the clip."""
        obs, action, reward, next_obs, done = batch
        if noise is None:
            dt = _head_dtype(self.actor.compute_dtype)
            shape = (obs.shape[0], self.action_dim)
            noise = tuple(normal_draw(shape, gen, dt, self.device) for _ in range(2))
        eps_next, eps_new = noise

        with torch.no_grad():
            next_a, next_logp = sample_action(state.actor, next_obs, noise=eps_next)
            tq = (torch.minimum(state.target1(next_obs, next_a),
                                state.target2(next_obs, next_a))
                  - self.alpha * next_logp)
            tv = reward[:, None] + (1 - done[:, None]) * self.gamma * tq

        losses, norms = {}, {}
        for i, (critic, opt) in enumerate(((state.critic1, state.critic1_opt),
                                           (state.critic2, state.critic2_opt)), 1):
            loss = torch.mean((critic(obs, action) - tv) ** 2)
            norms[f"critic{i}_grad_norm"] = self._step(critic, opt, loss)
            losses[f"critic{i}_loss"] = loss.detach()

        mean, log_std = state.actor(obs)
        new_a, logp = _squash(mean, log_std, None, eps_new)
        q = torch.minimum(state.critic1(obs, new_a), state.critic2(obs, new_a))
        a_loss = torch.mean(self.alpha * logp - q)
        # grads of the actor only
        norms["actor_grad_norm"] = self._step(state.actor, state.actor_opt, a_loss)
        diag = {"q_mean": q.detach().mean(), "logp_mean": logp.detach().mean(),
                "log_std_mean": log_std.detach().mean(), **norms}

        with torch.no_grad():
            for target, critic in ((state.target1, state.critic1),
                                   (state.target2, state.critic2)):
                tp = list(target.parameters())
                torch._foreach_mul_(tp, 1 - self.tau)
                torch._foreach_add_(tp, list(critic.parameters()), alpha=self.tau)
        return state, {"actor_loss": a_loss.detach(), **losses,
                       **{k: diag[k] for k in UPDATE_DIAGNOSTICS}}
