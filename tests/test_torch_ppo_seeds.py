"""``examples/ppo_seeds.py``: the exact one-sided Mann-Whitney test against
scipy's, the tail statistic against ``tests/test_learning_curves.py``'s,
the SAC and study gates restated from its tests on the committed CSVs, each
trainer's committed flags, the CSV comparison, and a run of two seeds on
the CPU."""

import argparse
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


def test_sac_scale_gate_restates_jax_test():
    """``test_sac_scale_curve_learns``'s arithmetic: JAX's committed curve
    passes, the port's PR 13 curve (track_0019) misses."""
    c = ppo_seeds.load(os.path.join(MEDIA, "sac_scale_curve.csv"))
    r, d = np.asarray(c["reward"]), np.asarray(c["done_rate"])
    n = len(r)
    g = ppo_seeds.sac_scale_gate(c)
    assert g["passes"] and g["iters"] == n == 1200
    assert g["stat"] == pytest.approx(r[-n // 4:].mean() - r[: n // 4].mean(), rel=1e-12)
    assert g["done_ratio"] == pytest.approx(d[-n // 4:].mean() / d[: n // 4].mean(),
                                            rel=1e-12)
    port = ppo_seeds.sac_scale_gate(
        ppo_seeds.load(os.path.join(MEDIA, "sac_torch_scale_curve.csv")))
    assert not port["passes"] and port["stat"] < 0.1


def test_sac_bitmap_gate_restates_jax_test():
    """``test_bitmap_sac_curve_rises``' arithmetic: JAX's committed curve
    (152 rows) passes, the port's PR 13 curve (400 rows) misses and passes
    on its first 200 rows."""
    c = ppo_seeds.load(os.path.join(MEDIA, "sac_bitmap_curve.csv"))
    r = np.asarray(c["reward_mean"])
    n = len(r)
    k = max(3, n // 10)
    g = ppo_seeds.sac_bitmap_gate(c)
    assert g["passes"] and n == 152
    assert g["stat"] == pytest.approx(r[-k:].mean() - r[2: 2 + k].mean(), rel=1e-12)
    port = ppo_seeds.load(os.path.join(MEDIA, "sac_torch_bitmap_curve.csv"))
    assert not ppo_seeds.sac_bitmap_gate(port)["passes"]
    first = {key: v[:200] for key, v in port.items()}
    assert ppo_seeds.sac_bitmap_gate(first)["passes"]
    short = {key: v[:49] for key, v in port.items()}
    assert not ppo_seeds.sac_bitmap_gate(short)["passes"]


def test_generalization_gate_restates_jax_test():
    """``test_generalization_study_artifact``'s limits: JAX's committed study
    passes; the port's (PR 15) misses on three rows."""
    jax_rows = ppo_seeds.load_rows(os.path.join(MEDIA, "generalization.csv"))
    assert ppo_seeds.generalization_gate(jax_rows) == {"passes": True, "misses": []}
    port = ppo_seeds.generalization_gate(
        ppo_seeds.load_rows(os.path.join(MEDIA, "generalization_torch.csv")))
    assert port["misses"] == ["track_0412", "track_0613", "track_narrow"]
    summary = ppo_seeds.study_summary([os.path.join(MEDIA, "generalization_torch.csv")],
                                      [os.path.join(MEDIA, "generalization.csv")])
    row = summary["tracks"]["track_0412"]
    assert row["crash_rate"]["median"] == 0.5256 and row["split"] == "train"
    assert row["reference"]["generalization.csv"]["crash_rate"] == "0.0156"


@pytest.mark.parametrize("trainer", sorted(ppo_seeds.TRAINERS))
def test_trainer_flags_are_the_committed_ones(trainer):
    args = argparse.Namespace(
        trainer=trainer, envs=None, iters=None, multi_map=False, trainer_args="--device cpu")
    flags = ppo_seeds.trainer_flags(args, 3, "/x/s3")
    module, committed, saves = ppo_seeds.TRAINERS[trainer]
    assert flags[:2] == ["-m", module] and flags[2:2 + len(committed)] == committed
    rest = flags[2 + len(committed):]
    assert rest[:4] == ["--seed", "3", "--log-csv", "/x/s3.csv"]
    assert ("--save" in rest) == saves and rest[-2:] == ["--device", "cpu"]
    args.envs, args.iters = 8, 2
    flags = ppo_seeds.trainer_flags(args, 0, "/x/s0")
    assert flags[flags.index("--envs") + 1] == "8" and flags[flags.index("--iters") + 1] == "2"
