"""``learning_ab.py ppo``, the arm that runs JAX's own
``examples/train_ppo.py --multi-map`` unmodified on the CPU under a chosen
key law, checked without training: the child's command line and
environment for each ``--law``, the law a child started with that
environment sees, and the ``ppo-child`` bootstrap's log line and hand-off
to the trainer through ``runpy``.
"""

import argparse
import os
import subprocess
import sys

import pytest

import learning_ab

# split(k, 3)[1] against split(k, 5)[1]: equal under JAX 0.5's law, where
# split(k, n)[j] does not depend on n, and not under the older law
PROBE = ("import jax; k = jax.random.PRNGKey(3); "
         "a = jax.random.key_data(jax.random.split(k, 3)[1]).tolist(); "
         "b = jax.random.key_data(jax.random.split(k, 5)[1]).tolist(); "
         "print('equal' if a == b else 'differ', "
         "jax.config.jax_threefry_partitionable)")


def _args(law: str, tmp_path) -> argparse.Namespace:
    return learning_ab.ppo_parser().parse_args(
        ["--law", law, "--envs", "64", "--iters", "3", "--seed", "5",
         "--log-csv", str(tmp_path / "curve.csv")])


@pytest.mark.parametrize("law, flag", [("jax09", "1"), ("fresh", "0")])
def test_ppo_child_argv_and_env(law, flag, tmp_path):
    argv, env = learning_ab.ppo_child(_args(law, tmp_path), "/ckpt/dir")
    assert argv == [sys.executable, os.path.abspath(learning_ab.__file__), "ppo-child",
                    "--multi-map", "--envs", "64", "--iters", "3", "--seed", "5",
                    "--log-csv", str(tmp_path / "curve.csv"), "--save", "/ckpt/dir"]
    assert env["JAX_THREEFRY_PARTITIONABLE"] == flag
    assert (env["JAX_PLATFORMS"], env["RGT_PLATFORM"]) == ("cpu", "cpu")
    assert learning_ab.TRAIN_PPO == os.path.join(os.path.dirname(
        os.path.abspath(learning_ab.__file__)), "examples", "train_ppo.py")
    assert os.path.isfile(learning_ab.TRAIN_PPO)


def test_ppo_law_is_required(tmp_path):
    with pytest.raises(SystemExit):
        learning_ab.ppo_parser().parse_args(["--log-csv", str(tmp_path / "c.csv")])


@pytest.mark.parametrize("law, seen", [("jax09", "equal True"), ("fresh", "differ False")])
def test_ppo_child_env_sets_the_key_law(law, seen, tmp_path):
    _, env = learning_ab.ppo_child(_args(law, tmp_path), str(tmp_path))
    out = subprocess.run([sys.executable, "-c", PROBE], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[-2] == seen


def test_ppo_child_logs_the_law_and_runs_the_trainer(monkeypatch, tmp_path, capsys):
    script = tmp_path / "trainer.py"
    script.write_text("import sys\nopen(sys.argv[0] + '.argv', 'w').write(repr(sys.argv))\n"
                      "assert __name__ == '__main__'\n")
    monkeypatch.setattr(learning_ab, "TRAIN_PPO", str(script))
    monkeypatch.setattr(sys, "argv", list(sys.argv))
    monkeypatch.setenv("JAX_THREEFRY_PARTITIONABLE", "1")
    assert learning_ab.ppo_child_main(["--multi-map", "--envs", "8"]) == 0
    log = capsys.readouterr().out.splitlines()[0]
    import jax

    assert log.startswith(f"JAX {jax.__version__}: JAX_THREEFRY_PARTITIONABLE=1 "
                          f"jax_threefry_partitionable={jax.config.jax_threefry_partitionable}")
    assert eval((tmp_path / "trainer.py.argv").read_text()) == [str(script), "--multi-map",
                                                                 "--envs", "8"]
