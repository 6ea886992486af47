"""Train several seeds of train_ppo on one card and compare sets of curves.

Three commands:

- ``run``: ``examples.train_ppo`` with the committed flags (``--envs 16384
  --iters 100``) for each seed of ``--seeds``, ``--jobs`` processes at a
  time on the one card, each writing ``<out>/<prefix>_seedS.csv`` and its
  log.  ``--root`` runs another checkout's trainer (its own package), so
  that two commits can be compared in one call.
- ``summary``: for each set of CSVs, the tail of every curve (the mean
  ``speed_mean`` over the last tenth of the iterations, the statistic of
  ``tests/test_learning_curves.py::_assert_learns``), its speed at one
  iteration, and the one-sided Mann-Whitney U test of set A below set B,
  exact (every split of the pooled tails enumerated).  Prints JSON.
- ``compare``: two CSVs column by column, as written, except ``wall_s``.

Usage:
    python -m red_gym_tpu_torch.examples.ppo_seeds run --seeds 0-9 --multi-map \\
        --jobs 4 --out chiprun_out/curves --prefix ppo_torch_multimap
    python -m red_gym_tpu_torch.examples.ppo_seeds summary \\
        --a 'docs/media/ppo_torch_multimap_seed*.csv' \\
        --b 'docs/media/ppo_multimap_seed*.csv' --at 60
    python -m red_gym_tpu_torch.examples.ppo_seeds compare a.csv b.csv
"""

from __future__ import annotations

import argparse
import csv
import glob
import itertools
import json
import os
import shlex
import subprocess
import sys
import time

TRAINER = "red_gym_tpu_torch.examples.train_ppo"


def parse_seeds(text: str) -> list[int]:
    """'0-9' or '0,3,5' or '2' -> the seeds."""
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def load(path: str) -> dict:
    """A curve CSV -> {column: list of floats}."""
    with open(path) as f:
        rows = list(csv.DictReader(f))
    return {k: [float(r[k]) for r in rows] for k in rows[0]}


def tail(curve: dict) -> float:
    """The mean speed over the last tenth of the iterations (at least one)."""
    s = curve["speed_mean"]
    k = max(1, len(s) // 10)
    return sum(s[-k:]) / k


def mann_whitney_less(a: list, b: list) -> tuple[float, float]:
    """The one-sided Mann-Whitney test that the values of ``a`` lie below
    those of ``b`` -> (U, p): U counts the pairs (x in a, y in b) with x > y
    (a tie counts a half), and p is the share of the C(n, len(a)) splits of
    the pooled values into sets of the same sizes whose U is at most the
    observed one: exact, by enumeration."""
    def u_of(xs, ys):
        return sum((x > y) + 0.5 * (x == y) for x in xs for y in ys)

    u = u_of(a, b)
    pooled = list(a) + list(b)
    n, total, low = len(pooled), 0, 0
    for pick in itertools.combinations(range(n), len(a)):
        chosen = set(pick)
        xs = [pooled[i] for i in pick]
        ys = [pooled[i] for i in range(n) if i not in chosen]
        total += 1
        low += u_of(xs, ys) <= u
    return u, low / total


def summary(args) -> dict:
    sets = {}
    for name, pattern in (("a", args.a), ("b", args.b)):
        files = sorted(glob.glob(pattern))
        if not files:
            raise SystemExit(f"no CSV matches {pattern}")
        rows = []
        for f in files:
            c = load(f)
            row = {"file": os.path.basename(f), "tail": tail(c),
                   "iters": len(c["speed_mean"]),
                   f"speed_at_{args.at}": c["speed_mean"][args.at],
                   "last5": sum(c["speed_mean"][-5:]) / 5}
            rows.append(row)
        sets[name] = rows
    u, p = mann_whitney_less([r["tail"] for r in sets["a"]],
                             [r["tail"] for r in sets["b"]])
    return {"a": sets["a"], "b": sets["b"], "U": u, "p_a_below_b": p,
            "n_a": len(sets["a"]), "n_b": len(sets["b"])}


def compare(a: str, b: str) -> dict:
    """Column by column, the values as the CSVs hold them, except wall_s."""
    with open(a) as f:
        ra = list(csv.reader(f))
    with open(b) as f:
        rb = list(csv.reader(f))
    cols = [c for c in ra[0] if c in rb[0] and c != "wall_s"]
    ia, ib = [ra[0].index(c) for c in cols], [rb[0].index(c) for c in cols]
    n = min(len(ra), len(rb)) - 1
    differ = {c: [r for r in range(n) if ra[r + 1][i] != rb[r + 1][j]]
              for c, i, j in zip(cols, ia, ib)}
    return {"rows": n, "columns": cols, "equal": not any(differ.values()),
            "first_differing_row": {c: d[0] for c, d in differ.items() if d}}


def run(args) -> int:
    root = os.path.abspath(args.root)
    os.makedirs(args.out, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=root)
    # build the kernels once, so that the jobs do not all run nvcc (where
    # there is no nvcc, the CPU runs need none)
    subprocess.run([sys.executable, "-c", "from red_gym_tpu_torch.ops import _build; "
                    "_build.build_all()"], cwd=root, env=env, capture_output=True)
    pending, running, failed = list(parse_seeds(args.seeds)), [], []
    t0 = time.time()
    while pending or running:
        while pending and len(running) < args.jobs:
            seed = pending.pop(0)
            stem = os.path.join(os.path.abspath(args.out), f"{args.prefix}_seed{seed}")
            flags = ["--envs", str(args.envs), "--iters", str(args.iters), "--seed",
                     str(seed), "--log-csv", stem + ".csv", "--save", stem + "_ckpt.pt"]
            flags += ["--multi-map"] if args.multi_map else []
            flags += shlex.split(args.trainer_args)
            log = open(stem + ".log", "w")
            running.append((seed, subprocess.Popen([sys.executable, "-m", TRAINER] + flags,
                                                   cwd=root, env=env,
                                                   stdout=log, stderr=subprocess.STDOUT),
                            log, stem))
        time.sleep(1.0)
        for item in list(running):
            seed, proc, log, stem = item
            if proc.poll() is None:
                continue
            running.remove(item)
            log.close()
            if os.path.exists(stem + "_ckpt.pt"):
                os.remove(stem + "_ckpt.pt")
            print(f"seed {seed}: exit {proc.returncode} at {time.time() - t0:.0f} s",
                  flush=True)
            if proc.returncode:
                failed.append(seed)
                print(open(stem + ".log").read()[-3000:], flush=True)
    return 1 if failed else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--seeds", default="0-9")
    r.add_argument("--multi-map", action="store_true")
    r.add_argument("--envs", type=int, default=16384)
    r.add_argument("--iters", type=int, default=100)
    r.add_argument("--jobs", type=int, default=4)
    r.add_argument("--out", default="chiprun_out/curves")
    r.add_argument("--prefix", default="ppo_torch")
    r.add_argument("--root", default=".", help="the checkout whose trainer runs")
    r.add_argument("--trainer-args", default="",
                   help="more train_ppo flags, e.g. '--device cpu --scan-mode exact'")
    s = sub.add_parser("summary")
    s.add_argument("--a", required=True, help="glob of set A's CSVs")
    s.add_argument("--b", required=True, help="glob of set B's CSVs")
    s.add_argument("--at", type=int, default=60, help="iteration whose speed to report")
    c = sub.add_parser("compare")
    c.add_argument("csv_a")
    c.add_argument("csv_b")
    args = ap.parse_args(argv)
    if args.cmd == "run":
        return run(args)
    out = summary(args) if args.cmd == "summary" else compare(args.csv_a, args.csv_b)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
