"""Controls and planted faults: the reference put in the program's place.

Each function here has the signature of the comparison it stands beside
(``checks.sim`` or ``checks.train``) and returns the same numbers, but the
side that the program's outputs would fill is the reference itself,
computed in a lower precision (``tf32``: float32 matrix products in TF32,
the nearest precision below the configurations' float32 with TF32 off) or
with a fault planted (``half_batch``: each minibatch's loss over half its
rows).  The program's run only supplies the inputs (states, actions,
rollouts); its outputs are not read.  ``benchmark/control.py`` runs them on
the card; a limit has to lie below what they read.
"""

from __future__ import annotations

import contextlib

from harness import checks


@contextlib.contextmanager
def tf32(on: bool):
    import torch

    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def step_gaps_tf32(rcfg, rparams, records, device, only=None) -> checks.Gaps:
    """The reference's steps in TF32 held to the same steps in float32."""
    gaps = checks.Gaps()
    for rec in records:
        envs = checks.compared_envs(rec, only)
        with tf32(False):
            mid, out = checks.reference_step(rcfg, rparams, rec, device)
        with tf32(True):
            mid_t, out_t = checks.reference_step(rcfg, rparams, rec, device)
        gaps.add(mid_t, mid, envs)
        if out is not None:
            gaps.add(out_t, out, envs)
    return gaps


def sim_tf32(cell, maps, records, device) -> list:
    rcfg, rparams = checks.reference_sim(cell, maps, device)
    return _all(step_gaps_tf32(rcfg, rparams, records, device).numbers())


def _learner_side(cell, weights, rec, half: bool):
    """A reference learner in the program's place, over the program's
    rollouts -> (losses, first gradient, weights after).  With ``half``,
    each minibatch keeps its first half of rows, the mean taken over them."""
    import torch

    import ppo_update

    h = cell.config["ppo"]
    learner = ppo_update.Learner(weights, h)
    perms = rec.perms
    if half:
        mb = perms[0][0].numel() // h["minibatches"]
        perms = [[torch.cat([p[i * mb:i * mb + mb // 2] for i in range(h["minibatches"])])
                  for p in epochs] for epochs in perms]
    losses = [loss for loss, _ in checks.follow(cell, learner, rec.rollouts, perms)]
    return losses, learner.first_grad, {k: v.detach() for k, v in learner.w.items()}


def _train(cell, maps, weights, rec, device, side: str) -> list:
    if side == "tf32":
        with tf32(True):
            losses, grad, after = _learner_side(cell, weights, rec, half=False)
    else:
        losses, grad, after = _learner_side(cell, weights, rec, half=True)
    with tf32(False):
        numbers = checks.learner_numbers(cell, weights, rec.rollouts, rec.perms, losses,
                                         grad, after)
    if side == "tf32":
        only = checks.checked_maps(cell, maps, rec.seed)
        rcfg, rparams = checks.reference_sim(cell, maps, device, only)
        numbers.update(step_gaps_tf32(rcfg, rparams, rec.steps, device, only).numbers())
    return _all(numbers)


def train_tf32(cell, maps, weights, rec, losses, first_grad, after, device) -> list:
    return _train(cell, maps, weights, rec, device, "tf32")


def train_half_batch(cell, maps, weights, rec, losses, first_grad, after, device) -> list:
    return _train(cell, maps, weights, rec, device, "half_batch")


def _all(numbers: dict) -> list:
    return [(k, float(v), float("inf")) for k, v in numbers.items()]


CONTROLS = {"sim": {"tf32": sim_tf32},
            "train": {"tf32": train_tf32, "half_batch": train_half_batch}}
