"""Train several seeds of one of the port's trainers on one card and compare
sets of curves.

``--trainer`` names the trainer and its committed flags (``TRAINERS``):
``ppo`` (the default; ``examples.train_ppo --envs 16384 --iters 100``),
``sac_scale`` (``train_sac_scale --envs 128 --iters 1200 --updates-per-step
4 --batch-size 512``), ``sac_bitmap`` (``train_sac_bitmap_scale --envs 32
--iters 400 --steps-per-iter 16 --bitmap 128 --f32 --alpha 0.02``) and
``generalization`` (``generalization_study --envs 4096 --iters 400
--eval-envs-per-track 4096 --eval-steps 3000``).

Three commands:

- ``run``: the trainer with its committed flags (``--envs`` and ``--iters``
  replace theirs) for each seed of ``--seeds``, ``--jobs`` processes at a
  time on the one card, each writing ``<out>/<prefix>_seedS.csv`` and its
  log.  ``--root`` runs another checkout's trainer (its own package), so
  that two commits can be compared in one call.
- ``summary``: for each set of CSVs, each curve's gate statistic
  (``curve_stat``): for ``ppo`` the tail (the mean ``speed_mean`` over the last
  tenth of the iterations, the statistic of
  ``tests/test_learning_curves.py::_assert_learns``) and the speed at one
  iteration; for the SAC trainers the rise of the reward and whether JAX's
  gate passes; for ``generalization`` each track's row and the gate.  Then
  the one-sided Mann-Whitney U test of set A's statistic below set B's,
  exact (every split of the pooled values enumerated), and how many of A's
  lie below every one of B's.  Prints JSON.
- ``compare``: two CSVs column by column, as written, except the time
  columns (``wall_s``, ``secs``).

Usage:
    python -m red_gym_tpu_torch.examples.ppo_seeds run --seeds 0-9 --multi-map \\
        --jobs 4 --out chiprun_out/curves --prefix ppo_torch_multimap
    python -m red_gym_tpu_torch.examples.ppo_seeds run --trainer sac_bitmap --seeds 0-9 \\
        --jobs 5 --out chiprun_out/curves --prefix sac_torch_bitmap
    python -m red_gym_tpu_torch.examples.ppo_seeds summary \\
        --a 'docs/media/ppo_torch_multimap_seed*.csv' \\
        --b 'docs/media/ppo_multimap_seed*.csv' --at 60
    python -m red_gym_tpu_torch.examples.ppo_seeds summary --trainer sac_scale \\
        --a 'docs/media/sac_torch_scale_seed*.csv' \\
        --b 'docs/media/sac_jax_cpu_track0019_scale_seed*.csv'
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
import statistics
import subprocess
import sys
import time

# trainer: (module, its committed flags, whether it takes --save)
TRAINERS = {
    "ppo": ("red_gym_tpu_torch.examples.train_ppo", ["--envs", "16384", "--iters", "100"],
            True),
    "sac_scale": ("red_gym_tpu_torch.examples.train_sac_scale",
                  ["--envs", "128", "--iters", "1200", "--updates-per-step", "4",
                   "--batch-size", "512"], True),
    "sac_bitmap": ("red_gym_tpu_torch.examples.train_sac_bitmap_scale",
                   ["--envs", "32", "--iters", "400", "--steps-per-iter", "16", "--bitmap",
                    "128", "--f32", "--alpha", "0.02"], False),
    "generalization": ("red_gym_tpu_torch.examples.generalization_study",
                       ["--envs", "4096", "--iters", "400", "--eval-envs-per-track", "4096",
                        "--eval-steps", "3000"], False),
}
TIME_COLUMNS = ("wall_s", "secs")


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


def sac_scale_gate(curve: dict) -> dict:
    """``tests/test_learning_curves.py::test_sac_scale_curve_learns`` on one
    curve: the mean reward of the last quarter of the iterations must exceed
    the first quarter's by more than 0.1, and the last quarter's done rate
    must be below 0.9 x the first's.  ``stat`` is the rise of the reward."""
    r, d = curve["reward"], curve["done_rate"]
    n = len(r)
    head_r, tail_r = statistics.fmean(r[: n // 4]), statistics.fmean(r[-n // 4:])
    head_d, tail_d = statistics.fmean(d[: n // 4]), statistics.fmean(d[-n // 4:])
    return {"stat": tail_r - head_r, "iters": n, "reward_head": head_r,
            "reward_tail": tail_r, "done_head": head_d, "done_tail": tail_d,
            "done_ratio": tail_d / head_d if head_d else None,
            "passes": bool(tail_r > head_r + 0.1 and tail_d < 0.9 * head_d)}


def sac_bitmap_gate(curve: dict) -> dict:
    """``tests/test_learning_curves.py::test_bitmap_sac_curve_rises`` on one
    curve: at least 50 iterations, and the mean reward of the last tenth (at
    least 3) above that of the tenth after the 2 warm-up iterations by more
    than 0.1.  ``stat`` is that rise."""
    r = curve["reward_mean"]
    n = len(r)
    k = max(3, n // 10)
    head, tail_r = statistics.fmean(r[2: 2 + k]), statistics.fmean(r[-k:])
    return {"stat": tail_r - head, "iters": n, "reward_head": head, "reward_tail": tail_r,
            "passes": bool(n >= 50 and tail_r > head + 0.1)}


def generalization_gate(rows: list) -> dict:
    """``tests/test_learning_curves.py::test_generalization_study_artifact``
    on one study's rows: 9 train and 2 held-out tracks; every train track
    but track_0208 under 5 % crashes at more than 6 m/s; track_wide under
    1 % at more than 6 m/s; track_narrow under 5 % at more than 4 m/s.
    ``misses`` names each row that fails."""
    train = [r for r in rows if r["split"] == "train"]
    hold = [r for r in rows if r["split"] == "holdout"]
    misses = [] if (len(train), len(hold)) == (9, 2) else ["split sizes"]
    limits = {r["track"]: (0.05, 6.0) for r in train if r["track"] != "track_0208"}
    limits.update({r["track"]: ((0.01, 6.0) if "wide" in r["track"] else (0.05, 4.0))
                   for r in hold})
    for r in rows:
        crash, speed = limits.get(r["track"], (None, None))
        if crash is not None and not (float(r["crash_rate"]) < crash
                                      and float(r["speed_mean"]) > speed):
            misses.append(r["track"])
    if not any(r["track"] == "track_0208" for r in train):
        misses.append("track_0208 absent")
    return {"passes": not misses, "misses": misses}


def load_rows(path: str) -> list:
    """A CSV -> its rows as dicts of strings."""
    with open(path) as f:
        return list(csv.DictReader(f))


def curve_stat(trainer: str, path: str, at: int) -> dict:
    """One curve's gate statistic (``stat``) and what the gate reads."""
    c = load(path)
    if trainer == "sac_scale":
        return sac_scale_gate(c)
    if trainer == "sac_bitmap":
        return sac_bitmap_gate(c)
    return {"stat": tail(c), "tail": tail(c), "iters": len(c["speed_mean"]),
            f"speed_at_{at}": c["speed_mean"][at], "last5": sum(c["speed_mean"][-5:]) / 5}


def study_summary(a_files: list, b_files: list) -> dict:
    """Per track, over set A's studies: the median and range of each
    numeric column, beside set B's rows; each study's gate."""
    studies = {os.path.basename(f): load_rows(f) for f in a_files}
    ref = {os.path.basename(f): load_rows(f) for f in b_files}
    tracks = {}
    for name, rows in studies.items():
        for r in rows:
            t = tracks.setdefault(r["track"], {"split": r["split"]})
            for k, v in r.items():
                if k not in ("track", "split"):
                    t.setdefault(k, []).append(float(v))
    for t, cols in tracks.items():
        for k in [k for k in cols if k != "split"]:
            v = cols[k]
            finite = [x for x in v if x == x]
            cols[k] = {"values": v, "median": statistics.median(finite) if finite else None,
                       "min": min(finite) if finite else None,
                       "max": max(finite) if finite else None}
        cols["reference"] = {n: next((r for r in rows if r["track"] == t), None)
                             for n, rows in ref.items()}
    return {"tracks": tracks,
            "gates": {n: generalization_gate(rows) for n, rows in studies.items()},
            "reference_gates": {n: generalization_gate(rows) for n, rows in ref.items()}}


def summary(args) -> dict:
    sets = {}
    for name, pattern in (("a", args.a), ("b", args.b)):
        files = sorted(glob.glob(pattern))
        if not files:
            raise SystemExit(f"no CSV matches {pattern}")
        sets[name] = files
    if args.trainer == "generalization":
        return study_summary(sets["a"], sets["b"])
    rows = {k: [{"file": os.path.basename(f), **curve_stat(args.trainer, f, args.at)}
                for f in files] for k, files in sets.items()}
    a, b = [r["stat"] for r in rows["a"]], [r["stat"] for r in rows["b"]]
    u, p = mann_whitney_less(a, b)
    return {"trainer": args.trainer, "a": rows["a"], "b": rows["b"], "U": u,
            "p_a_below_b": p, "n_a": len(a), "n_b": len(b),
            "a_below_every_b": sum(x < min(b) for x in a),
            "a_below_each_b": {r["file"]: sum(x < r["stat"] for x in a) for r in rows["b"]}}


def compare(a: str, b: str) -> dict:
    """Column by column, the values as the CSVs hold them, except the time
    columns."""
    with open(a) as f:
        ra = list(csv.reader(f))
    with open(b) as f:
        rb = list(csv.reader(f))
    cols = [c for c in ra[0] if c in rb[0] and c not in TIME_COLUMNS]
    ia, ib = [ra[0].index(c) for c in cols], [rb[0].index(c) for c in cols]
    n = min(len(ra), len(rb)) - 1
    differ = {c: [r for r in range(n) if ra[r + 1][i] != rb[r + 1][j]]
              for c, i, j in zip(cols, ia, ib)}
    return {"rows": n, "columns": cols, "equal": not any(differ.values()),
            "first_differing_row": {c: d[0] for c, d in differ.items() if d}}


def trainer_flags(args, seed: int, stem: str) -> list:
    """The command line of one seed's run: the trainer's committed flags,
    ``--envs`` and ``--iters`` where given, the seed, its CSV (and
    checkpoint), ``--multi-map`` and ``--trainer-args``."""
    module, committed, saves = TRAINERS[args.trainer]
    flags = list(committed)
    for name, value in (("--envs", args.envs), ("--iters", args.iters)):
        if value is not None:
            flags[flags.index(name) + 1] = str(value)
    flags += ["--seed", str(seed), "--log-csv", stem + ".csv"]
    flags += ["--save", stem + "_ckpt.pt"] if saves else []
    flags += ["--multi-map"] if args.multi_map else []
    return ["-m", module] + flags + shlex.split(args.trainer_args)


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
            log = open(stem + ".log", "w")
            running.append((seed, subprocess.Popen([sys.executable]
                                                   + trainer_flags(args, seed, stem),
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
    r.add_argument("--trainer", choices=sorted(TRAINERS), default="ppo")
    r.add_argument("--seeds", default="0-9")
    r.add_argument("--multi-map", action="store_true", help="train_ppo's --multi-map")
    r.add_argument("--envs", type=int, default=None, help="default: the trainer's committed")
    r.add_argument("--iters", type=int, default=None, help="default: the trainer's committed")
    r.add_argument("--jobs", type=int, default=4)
    r.add_argument("--out", default="chiprun_out/curves")
    r.add_argument("--prefix", default="ppo_torch")
    r.add_argument("--root", default=".", help="the checkout whose trainer runs")
    r.add_argument("--trainer-args", default="",
                   help="more trainer flags, e.g. '--device cpu --scan-mode exact'")
    s = sub.add_parser("summary")
    s.add_argument("--trainer", choices=sorted(TRAINERS), default="ppo")
    s.add_argument("--a", required=True, help="glob of set A's CSVs")
    s.add_argument("--b", required=True, help="glob of set B's CSVs")
    s.add_argument("--at", type=int, default=60, help="ppo: the iteration whose speed to report")
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
