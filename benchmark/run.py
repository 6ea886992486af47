"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the program
(``red_gym_tpu_torch``) and ``BENCHMARK.json``.  The cell, its
configuration, its traffic mix, its limits and its per-layer metrics are
found by name under ``benchmark/`` (``harness.manifest``).  The last line
of standard output is one JSON object (``harness.result``); the numbers
compared for ``correct`` close standard error.  Needs one CUDA device per
chip the cell asks for, and exits with another code than 0 and no result
line without them.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

if __name__ == "__main__":
    sys.path[:0] = [HERE, os.path.join(HERE, "reference"), ROOT]
    from harness import cli

    sys.exit(cli.main(sys.argv[1:], ROOT))
