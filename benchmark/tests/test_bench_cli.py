"""Without a card the run exits with another code than 0 and prints no
result line."""

import os
import subprocess
import sys

from conftest import ROOT


def test_chip_absent_exits_without_a_line(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "fast_default.random",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
