"""JAX's learning-curve gates applied unchanged to the port's committed PPO
curves: ``_assert_learns`` of ``tests/test_learning_curves.py`` on
``docs/media/ppo_torch_seed{0,1,2}.csv`` and
``ppo_torch_multimap_seed{0,1,2}.csv``, and the two checks of its
``test_seed_variance_is_sane`` on the port's single-map files with its
constants (that test globs JAX's files, so the checks are restated here).

The curves come from the H100 with the committed flags:

    python -m red_gym_tpu_torch.examples.train_ppo --envs 16384 --iters 100 \\
        --seed S [--multi-map] --log-csv docs/media/ppo_torch_[multimap_]seedS.csv
"""

import os

import numpy as np
import pytest

from tests.test_learning_curves import MEDIA, _assert_learns, _load

SEEDS = (0, 1, 2)
SINGLE = [f"ppo_torch_seed{s}.csv" for s in SEEDS]
MULTI = [f"ppo_torch_multimap_seed{s}.csv" for s in SEEDS]


@pytest.mark.parametrize("name", SINGLE + MULTI)
def test_port_ppo_curve_learns(name):
    _assert_learns(_load(os.path.join(MEDIA, name)), name)


def test_port_single_map_seed_variance_is_sane():
    finals = np.asarray([_load(os.path.join(MEDIA, n))["speed_mean"][-5:].mean()
                         for n in SINGLE])
    assert finals.std() < 0.5 * finals.mean(), f"seed endpoint spread too wide: {finals}"
    assert finals.max() > 6.0, "no seed reached racing speed"
