"""The port's PPO held to JAX's own PPO trainer at one reduced size, on the
committed curves only (no training here).

Three arms of ``train_ppo --multi-map`` at N envs x 100 iterations (cut from
the 16384 envs of JAX's TPU curves), every other flag the trainer's
default, seeds 0-7 each:

- J09: JAX's own ``examples/train_ppo.py`` on the CPU under JAX >= 0.5's key
  law (``learning_ab.py ppo --law jax09``), the law the port follows;
- Jfresh: the same under the older law (``--law fresh``), fresh action noise
  every rollout;
- P: the port on the card (``ppo_seeds.py run --multi-map --envs N
  --iters 100 --seeds 0-7``).

Every J09 and P curve must pass JAX's gate (``_assert_learns``), and P's
tails (``ppo_seeds.tail``) must not lie below J09's: the exact one-sided
Mann-Whitney test (``ppo_seeds.mann_whitney_less``) at p >= 0.05.
"""

import os

import pytest

from red_gym_tpu_torch.examples import ppo_seeds
from tests.test_learning_curves import MEDIA, _assert_learns, _load

N, ITERS, ROLLOUT = 1024, 100, 32
SEEDS = range(8)
J09 = [f"ppo_jax_cpu_multimap_jax09_n{N}_seed{s}.csv" for s in SEEDS]
FRESH = [f"ppo_jax_cpu_multimap_fresh_n{N}_seed{s}.csv" for s in SEEDS]
PORT = [f"ppo_torch_multimap_n{N}_seed{s}.csv" for s in SEEDS]


def _tails(names):
    return [ppo_seeds.tail(ppo_seeds.load(os.path.join(MEDIA, n))) for n in names]


@pytest.mark.parametrize("name", J09 + FRESH + PORT)
def test_ab_curve_has_the_arms_size(name):
    c = ppo_seeds.load(os.path.join(MEDIA, name))
    assert c["iter"] == list(range(ITERS))
    assert c["env_steps"] == [(i + 1) * N * ROLLOUT for i in range(ITERS)]


@pytest.mark.parametrize("name", J09 + PORT)
def test_ab_curve_learns(name):
    _assert_learns(_load(os.path.join(MEDIA, name)), name)


def test_port_is_not_below_jax09():
    _, p = ppo_seeds.mann_whitney_less(_tails(PORT), _tails(J09))
    assert p >= 0.05, f"the port's tails lie below JAX's at p = {p:.4f}"
