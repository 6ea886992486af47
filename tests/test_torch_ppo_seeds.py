"""``examples/ppo_seeds.py``: the exact one-sided Mann-Whitney test against
scipy's, the tail statistic against ``tests/test_learning_curves.py``'s,
the CSV comparison, and a run of two seeds on the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
from scipy import stats

from red_gym_tpu_torch.examples import ppo_seeds

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEDIA = os.path.join(ROOT, "docs", "media")


@pytest.mark.parametrize("n_a, n_b, seed", [(10, 3, 0), (10, 3, 1), (4, 4, 2), (3, 10, 3)])
def test_mann_whitney_matches_scipy_exact(n_a, n_b, seed):
    rng = np.random.default_rng(seed)
    a, b = rng.normal(0.0, 1.0, n_a), rng.normal(0.7, 1.0, n_b)
    u, p = ppo_seeds.mann_whitney_less(list(a), list(b))
    want = stats.mannwhitneyu(a, b, alternative="less", method="exact")
    assert u == want.statistic
    assert p == pytest.approx(want.pvalue, rel=1e-12)


def test_mann_whitney_extremes():
    """Every port tail below every reference tail: the smallest p of 10
    against 3 is 1 / C(13, 3) = 1/286; every one above: p = 1."""
    low, high = list(range(10)), [20.0, 21.0, 22.0]
    assert ppo_seeds.mann_whitney_less(low, high) == (0.0, 1 / 286)
    assert ppo_seeds.mann_whitney_less([x + 100 for x in low], high)[1] == 1.0


def test_tail_is_the_gate_statistic():
    """The tail of a committed JAX curve is _assert_learns's mean speed over
    the last tenth of the iterations."""
    f = os.path.join(MEDIA, "ppo_multimap_seed0.csv")
    c = ppo_seeds.load(f)
    s = np.asarray(c["speed_mean"])
    assert ppo_seeds.tail(c) == pytest.approx(s[-max(1, len(s) // 10):].mean(), rel=1e-15)
    assert ppo_seeds.parse_seeds("0-2,5,7-8") == [0, 1, 2, 5, 7, 8]


def test_compare_reads_columns_but_wall_s(tmp_path):
    a, b = tmp_path / "a.csv", tmp_path / "b.csv"
    a.write_text("iter,loss,wall_s,grad_norm\n0,0.5,1.00,2\n1,0.25,2.00,3\n")
    b.write_text("iter,loss,wall_s\n0,0.5,9.00\n1,0.250001,9.50\n")
    got = ppo_seeds.compare(str(a), str(b))
    assert got["columns"] == ["iter", "loss"] and got["rows"] == 2
    assert not got["equal"] and got["first_differing_row"] == {"loss": 1}
    assert ppo_seeds.compare(str(a), str(a))["equal"]


def test_run_two_seeds_on_cpu(tmp_path):
    """``run`` at a tiny size on the CPU: one CSV and log a seed, the
    checkpoints removed, JAX's seven columns then the diagnostics."""
    out = tmp_path / "curves"
    proc = subprocess.run(
        [sys.executable, "-m", "red_gym_tpu_torch.examples.ppo_seeds", "run", "--seeds",
         "0-1", "--jobs", "2", "--envs", "8", "--iters", "2", "--out", str(out),
         "--prefix", "t", "--trainer-args",
         "--device cpu --scan-mode exact --beams 64 --rollout 4"],
        cwd=ROOT, env=dict(os.environ, RED_GYM_TPU_TEXTURE_CACHE="off"),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert sorted(os.listdir(out)) == ["t_seed0.csv", "t_seed0.log", "t_seed1.csv",
                                       "t_seed1.log"]
    c0, c1 = ppo_seeds.load(str(out / "t_seed0.csv")), ppo_seeds.load(str(out / "t_seed1.csv"))
    assert list(c0)[:7] == ["iter", "env_steps", "loss", "reward_mean", "done_rate",
                            "speed_mean", "wall_s"]
    assert len(c0["loss"]) == 2 and c0["loss"] != c1["loss"]
