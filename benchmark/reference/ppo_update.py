"""PPO's update in plain PyTorch: the policy's forward pass, GAE, the
clipped loss and Adam over minibatches, for one trajectory.

It follows the program's trainer (``agents/ppo.py``) from the program's own
rollouts: the features, actions, rewards and done flags that the program
collected, and the minibatch permutations it drew.  Everything else (the
log-probabilities and values at collection, the advantages, the losses,
the gradients, the optimizer's steps) it works out again from its own
weights.  It imports nothing of the program.
"""

from __future__ import annotations

import math

import torch

LEAVES = ("hidden_0.weight", "hidden_0.bias", "hidden_1.weight", "hidden_1.bias",
          "mean.weight", "mean.bias", "value.weight", "value.bias", "log_std")


def forward(w: dict, feats, vels):
    """Linear (features + speed) -> tanh -> Linear -> tanh -> mean and value
    heads -> (mean (..., 2), log_std (2,), value (...))."""
    x = torch.cat([feats, vels[..., None]], dim=-1)
    x = torch.tanh(x @ w["hidden_0.weight"].T + w["hidden_0.bias"])
    x = torch.tanh(x @ w["hidden_1.weight"].T + w["hidden_1.bias"])
    mean = x @ w["mean.weight"].T + w["mean.bias"]
    value = (x @ w["value.weight"].T + w["value.bias"])[..., 0]
    return mean, w["log_std"], value


def log_prob(mean, log_std, act):
    z = (act - mean) / torch.exp(log_std)
    return torch.sum(-0.5 * z ** 2 - log_std - 0.5 * math.log(2 * math.pi), dim=-1)


def advantages(values, rewards, dones, last_value, gamma: float, lam: float):
    """GAE over (T, E) -> (advantages, returns)."""
    adv = torch.zeros_like(values)
    gae, next_v = torch.zeros_like(last_value), last_value
    for t in range(values.shape[0] - 1, -1, -1):
        keep = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_v * keep - values[t]
        gae = delta + gamma * lam * keep * gae
        adv[t] = gae
        next_v = values[t]
    return adv, adv + values


def minibatch_loss(w: dict, feats, vels, acts, logp_old, adv, ret, h: dict):
    """The clipped surrogate, half the squared value error and the entropy
    bonus, each a mean over the minibatch, with the advantages normalised
    by its mean and population standard deviation -> (loss, its scale: the
    sum of the three terms' magnitudes, which the loss, a difference of
    them, can lie far below)."""
    adv = (adv - adv.mean()) / (adv.std(unbiased=False) + 1e-8)
    mean, log_std, value = forward(w, feats, vels)
    ratio = torch.exp(log_prob(mean, log_std, acts) - logp_old)
    clipped = torch.clamp(ratio, 1 - h["clip_eps"], 1 + h["clip_eps"])
    pg = -torch.minimum(ratio * adv, clipped * adv).mean()
    vf = (0.5 * (value - ret) ** 2).mean()
    ent = torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e))
    scale = pg.abs() + h["vf_coef"] * vf + h["ent_coef"] * ent.abs()
    return pg + h["vf_coef"] * vf - h["ent_coef"] * ent, scale.detach()


class Learner:
    """The reference's weights and their Adam, updated one iteration at a
    time from the program's rollouts."""

    def __init__(self, weights: dict, h: dict):
        self.h = h
        self.w = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
        self.opt = torch.optim.Adam(self.w.values(), lr=h["lr"], betas=(0.9, 0.999),
                                    eps=1e-8)
        self.first_grad = None   # {leaf: gradient} of the first minibatch step

    def iteration(self, traj: dict, last_feats, last_vels, perms) -> tuple:
        """One iteration: ``traj`` holds the rollout's (T, E, ...) ``feats``,
        ``vels``, ``acts``, ``rewards`` and ``dones``; ``perms`` one
        permutation of the T*E samples an epoch.  -> (the mean minibatch
        loss, the mean of its scale)."""
        h = self.h
        with torch.no_grad():
            mean, log_std, values = forward(self.w, traj["feats"], traj["vels"])
            logp_old = log_prob(mean, log_std, traj["acts"])
            _, _, last_value = forward(self.w, last_feats, last_vels)
            adv, ret = advantages(values, traj["rewards"], traj["dones"], last_value,
                                  h["gamma"], h["gae_lambda"])
        n = adv.numel()
        data = [x.reshape((n,) + x.shape[2:]) for x in
                (traj["feats"], traj["vels"], traj["acts"], logp_old, adv, ret)]
        mb = perms[0].numel() // h["minibatches"]
        losses, scales = [], []
        for perm in perms:
            for i in range(h["minibatches"]):
                idx = perm[i * mb:(i + 1) * mb]
                loss, scale = minibatch_loss(self.w, *(x[idx] for x in data), h)
                scales.append(float(scale))
                self.opt.zero_grad(set_to_none=True)
                loss.backward()
                if self.first_grad is None:
                    self.first_grad = {k: v.grad.detach().clone() for k, v in self.w.items()}
                self.opt.step()
                losses.append(float(loss.detach()))
        return sum(losses) / len(losses), sum(scales) / len(scales)
