"""Read the controls of a cell on the card: the numbers that decide
``correct`` when the reference, in a lower precision or with a fault
planted, stands in the program's place (``harness.controls``).

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--control tf32]

Each seed runs the cell's set-up and a short window of the program, whose
recorded inputs both sides then take.  Prints one JSON line a seed:
{"seed", "control", "numbers": {name: reading}}.  A limit of the cell has
to lie below these readings (for the numbers the control separates).
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

if __name__ == "__main__":
    sys.path[:0] = [HERE, os.path.join(HERE, "reference"), ROOT]
    import importlib

    from harness import cli, controls, manifest

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="tf32")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args()
    cli.prepare_environment(ROOT)
    cell = manifest.find_cell(manifest.load_manifest(ROOT), args.workload, ROOT)

    import torch

    if not torch.cuda.is_available():
        sys.exit("the controls are read on the card")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    runner = importlib.import_module(f"harness.{cell.traffic['runner']}")
    check = controls.CONTROLS[cell.traffic["runner"]][args.control]
    for seed in (int(s) for s in args.seeds.split(",")):
        run = runner.run(cell, seed, args.seconds, False, torch.device("cuda", 0),
                         check=check)
        print(json.dumps({"seed": seed, "control": args.control,
                          "numbers": {k: v for k, v, _ in run.checks}}), flush=True)
