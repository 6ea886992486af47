"""Data-parallel PPO over torch.distributed (gloo, CPU) against one process.

The port's counterpart of tests/test_distributed.py.  P ranks, each holding
16/P of 16 envs, must compute what one process computes for all 16: every
random draw is made for all envs and sliced (``parallel.draws``), the
minibatch statistics and gradients are all-reduced (``agents/ppo.py``).
The worker runs at JAX's worker shape (tests/_distributed_worker.py: 16
envs, 2 agents, 54 beams, the exact scan with ``march_iters=8``, no scan
noise, rollout 4, 2 minibatches, 1 epoch, ScanPolicy hidden 32 stride 4),
with every fourth ego started 0.62 m behind the opponent (a 0.04 m gap)
so that envs restart within the 20 steps (JAX's poses restart none that
early), in
float64 (config and policy), as ``python -m tests.test_torch_parallel``
(the ``__main__`` block below), one process a rank.

Bars.  One ``train_step``, 2 ranks against 1: loss and parameter checksum
within rtol 1e-9; the reward within 1e-6 relative, since rewards are
stored float32 (as JAX's) and their mean is one float32 sum in one process
and a sum of rank sums here.  20 steps, 2 x 1 and 4 x 1 ranks against 1,
with resets among them: loss and checksum within rtol 1e-9 (JAX's bar is
rtol 2e-4 / atol 1e-5), every rank reporting the same numbers.  The drill:
rank 1 dies (``os._exit(9)``) before step 6, after the step-4 checkpoint;
both ranks restart from it, and the resumed tail equals the uninterrupted
run within rtol 1e-9.

The draw cases (``--draws``, ``_draw_cases``) hold the draws that the
runs above leave idle: scan noise in the "pool", "fresh" and "pool_rot"
modes and a multi-map rollout with ``randomize_starts``, with every
restarting env in rank 0's rows, so that rank 1 restarts none and only
advances its generator.  2 ranks against 1, each at its bar below.

The chain to JAX: the one-process ``train_step`` is held to JAX's within
1e-10 (tests/test_torch_ppo.py); P ranks equal one process here, which
closes the chain.

Every spawned run has a timeout; ``init_process_group`` has one of 30 s, so
a dead peer raises instead of hanging; children are killed in ``finally``.
"""

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ENV = 16
STEPS = 20
CRASH_ROWS = [1, 5]     # the draw cases' restarting envs: rank 0's of two
CRASH_BACK = 0.62       # m behind the opponent: a 0.04 m gap
DRAW_STEPS = 8          # PPO train steps of a draw case
MULTIMAP_STEPS = 40     # env steps of the multi-map draw case
RUN_TIMEOUT = 120


# --------------------------------------------------------------------------
# the worker: one rank of the data-parallel trainer
# --------------------------------------------------------------------------

def _checksum(policy) -> float:
    return float(sum(p.detach().double().abs().sum() for p in policy.parameters()))


def _behind(poses, rows, back=0.8):
    """``poses`` (E, 2, 3) with the egos of ``rows`` ``back`` m behind their
    opponent (0.8: a 0.22 m gap), which they run into."""
    opp = poses[rows, 1]
    heading = torch.stack([torch.cos(opp[:, 2]), torch.sin(opp[:, 2])], -1)
    poses[rows, 0, :2] = opp[:, :2] - back * heading
    return poses


def _start_poses(assets, track, rows=slice(1, None, 4), back=0.8):
    """JAX's worker poses, but every fourth ego (or those of ``rows``)
    behind the opponent, so that envs restart within the 20 steps."""
    poses = torch.as_tensor(assets.waypoint_start_poses(track, 2),
                            dtype=torch.float64).repeat(N_ENV, 1, 1)
    return _behind(poses, rows, back)


def _standing(obs):
    """Opponents that stand still: the draw cases' egos reach them sooner."""
    return torch.zeros(obs.poses_x.shape + (2,), dtype=obs.poses_x.dtype)


def _draw_cases(mesh, out):
    """The random draws of a step, with the restarting envs all in rank 0's
    rows of two (``CRASH_ROWS``), so that rank 1 resets none and takes the
    branch that only advances its generator.  PPO over DRAW_STEPS train
    steps, opponents standing, with scan noise "pool" and "fresh" (float64,
    exact scan) and
    "pool_rot" (float32, the fast scan's megakernel: the whole pool and an
    offset in one process, a rank's slab of its rows under a group); a
    multi-map rollout with ``randomize_starts`` (float64, pool noise).
    Writes each case's results and this rank's done envs at every
    ``reset_done`` to ``out``."""
    from red_gym_tpu_torch import assets, env as envlib, rollout
    from red_gym_tpu_torch.agents.ppo import PPO, PPOConfig, ScanPolicy
    from red_gym_tpu_torch.config import Integrator, SimConfig
    from red_gym_tpu_torch.ops import scan_fast
    from red_gym_tpu_torch.parallel import distributed as dist, sharding as sh

    counts = []
    reset_done = rollout.reset_done

    def counted(cfg, params, state, obs, done, *a, **k):
        counts.append(int(done.sum()))
        return reset_done(cfg, params, state, obs, done, *a, **k)

    rollout.reset_done = counted
    track = assets.packaged_tracks()[0]
    res = {}
    for case in ("pool", "fresh", "pool_rot"):
        fast = case == "pool_rot"
        cfg = SimConfig(num_agents=2, num_beams=54, timestep=0.01,
                        integrator=Integrator.RK4, dtype="float32" if fast else "float64",
                        scan_mode="fast" if fast else "exact", rt_spatial="nearest1",
                        rt_pose_stride=8, march_iters=8, scan_noise_std=0.01,
                        noise_mode=case, noise_pool_rows=64)
        assert scan_fast.use_megakernel(cfg) == fast
        params = sh.shard_params(mesh, envlib.make_params(cfg, track, ".png", device="cpu"))
        poses = dist.local_rows(_start_poses(assets, track, CRASH_ROWS, CRASH_BACK).to(cfg.tdtype), N_ENV)
        gen = torch.Generator().manual_seed(0)
        with sh.env_draws(mesh, poses.shape[0]):
            states, obs, *_ = rollout.batched_reset(cfg, params, poses, gen)
        policy = ScanPolicy(num_beams=54, hidden=32, scan_stride=4,
                            compute_dtype=cfg.tdtype).to(cfg.tdtype)
        ppo = PPO(cfg, params, PPOConfig(rollout_len=4, minibatches=2, epochs=1), policy,
                  opponent_plan=_standing, mesh=mesh)
        pstate = sh.replicate(mesh, ppo.init(torch.Generator().manual_seed(1)))
        counts.clear()
        r = {"losses": [], "checksums": [], "rewards": [], "resets": []}
        for _ in range(DRAW_STEPS):
            pstate, states, obs, metrics = ppo.train_step(pstate, states, obs)
            r["losses"].append(float(metrics["loss"]))
            r["rewards"].append(float(metrics["reward_mean"]))
            r["resets"].append(int(metrics["reset_steps"]))
            r["checksums"].append(_checksum(pstate.policy))
        res[case] = dict(r, local_dones=list(counts))

    tracks = assets.packaged_tracks()[:3]
    cfg = SimConfig(num_agents=2, num_beams=54, timestep=0.01, integrator=Integrator.RK4,
                    dtype="float64", march_iters=8, scan_noise_std=0.01,
                    noise_mode="pool", noise_pool_rows=64)
    params = sh.shard_params(mesh, envlib.make_multimap_params(cfg, tracks, device="cpu"))
    table = torch.as_tensor(assets.start_pose_table(tracks, 2), dtype=torch.float64)
    map_idx = (torch.arange(N_ENV) % len(tracks)).to(torch.int32)
    poses, map_idx = dist.local_rows(
        (_behind(table[map_idx.long()].clone(), CRASH_ROWS, CRASH_BACK), map_idx), N_ENV)
    act = torch.tensor([[0.0, 3.0], [0.0, 1.5]], dtype=torch.float64).expand(
        poses.shape[0], 2, 2)
    gen = torch.Generator().manual_seed(0)
    counts.clear()
    with sh.env_draws(mesh, poses.shape[0]):
        states, obs, *_ = rollout.batched_reset(cfg, params, poses, gen, map_idx=map_idx)
        carry, outs = rollout.make_rollout(cfg, params, lambda o, g: act, MULTIMAP_STEPS,
                                           randomize_starts=table)(
            rollout.RolloutCarry(states, obs), gen)
    res["multimap"] = {"x": carry.state.x.tolist(), "map_idx": carry.state.map_idx.tolist(),
                       "scans": carry.obs.scans.tolist(),
                       "done": outs["done"].T.tolist(), "local_dones": list(counts)}
    rollout.reset_done = reset_done
    with open(out, "w") as f:
        json.dump({"world": dist.world_size(), "rank": dist.rank(), "cases": res}, f)


def worker(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("init")
    ap.add_argument("world", type=int)
    ap.add_argument("rank", type=int)
    ap.add_argument("out")
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--die-at", type=int, default=-1)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--draws", action="store_true",
                    help="run _draw_cases in place of the trainer")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)

    from red_gym_tpu_torch import assets, env as envlib, rollout
    from red_gym_tpu_torch.agents.ppo import DIAGNOSTICS, PPO, PPOConfig, ScanPolicy
    from red_gym_tpu_torch.config import Integrator, SimConfig
    from red_gym_tpu_torch.parallel import distributed as dist, sharding as sh
    from red_gym_tpu_torch.utils import checkpoint as ckpt

    if args.world > 1:
        dist.initialize(args.init, args.world, args.rank, backend="gloo",
                        timeout=datetime.timedelta(seconds=30), device="cpu")
    assert dist.world_size() == args.world
    if args.draws:
        _draw_cases(sh.make_env_mesh(device="cpu"), args.out)
        dist.shutdown()
        return
    cfg = SimConfig(num_agents=2, num_beams=54, timestep=0.01,
                    integrator=Integrator.RK4, dtype="float64", march_iters=8,
                    scan_noise_std=0.0)
    track = assets.packaged_tracks()[0]
    mesh = sh.make_env_mesh(device="cpu")
    params = sh.shard_params(mesh, envlib.make_params(cfg, track, ".png", device="cpu"))

    # identical global poses on every rank, each keeping its rows
    poses = _start_poses(assets, track, back=CRASH_BACK)
    poses = dist.local_rows(poses, N_ENV)
    gen = torch.Generator().manual_seed(0)
    with sh.env_draws(mesh, poses.shape[0]):
        states, obs, *_ = rollout.batched_reset(cfg, params, poses, gen)

    policy = ScanPolicy(num_beams=54, hidden=32, scan_stride=4,
                        compute_dtype=torch.float64).double()
    ppo = PPO(cfg, params, PPOConfig(rollout_len=4, minibatches=2, epochs=1), policy,
              mesh=mesh)
    pstate = sh.replicate(mesh, ppo.init(torch.Generator().manual_seed(1)))
    checksum0 = _checksum(pstate.policy)

    start_step = 0
    if args.resume:
        tree, start_step = ckpt.restore_shards(
            args.ckpt_dir, like={"pstate": pstate, "states": states, "obs": obs}, mesh=mesh)
        pstate, states, obs = tree["pstate"], tree["states"], tree["obs"]

    losses, rewards, checksums, resets, diags = [], [], [], [], []
    for t in range(start_step, args.steps):
        if t == args.die_at and args.rank == args.world - 1:
            sys.stdout.flush()
            os._exit(9)   # abrupt death: no cleanup, no barrier
        pstate, states, obs, metrics = ppo.train_step(pstate, states, obs)
        losses.append(float(metrics["loss"]))
        rewards.append(float(metrics["reward_mean"]))
        resets.append(int(metrics["reset_steps"]))
        checksums.append(_checksum(pstate.policy))
        diags.append({k: float(metrics[k]) for k in DIAGNOSTICS})
        if args.ckpt_every and (t + 1) % args.ckpt_every == 0 \
                and (args.die_at < 0 or t + 1 <= args.die_at):
            ckpt.save_shards(args.ckpt_dir, {"pstate": pstate, "states": states,
                                             "obs": obs}, t + 1, mesh)
    with open(args.out, "w") as f:
        json.dump({"world": dist.world_size(), "rank": dist.rank(),
                   "start_step": start_step, "losses": losses, "rewards": rewards,
                   "checksums": checksums, "resets": resets, "diagnostics": diags,
                   "checksum_before": checksum0}, f)
    dist.shutdown()


# --------------------------------------------------------------------------
# spawning
# --------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(tmp, tag, world, *extra):
    """Start ``world`` ranks -> (processes, output paths)."""
    init = f"tcp://127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               RED_GYM_TPU_TEXTURE_CACHE="off")
    outs = [str(tmp / f"{tag}_{r}.json") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.test_torch_parallel", init, str(world), str(r),
         outs[r], *map(str, extra)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(world)]
    return procs, outs


def _finish(procs, outs, timeout=RUN_TIMEOUT):
    """Wait for every rank, assert success -> the ranks' JSON results."""
    logs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"rank failed ({p.returncode}):\n{log[-4000:]}"
    return [json.load(open(o)) for o in outs]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One process, 2 x 1 and 4 x 1 ranks over STEPS steps, the draw cases
    on one process and two ranks, and the drill's two runs (rank 1 dies
    before step 6; both restart from step 4)."""
    tmp = tmp_path_factory.mktemp("parallel")
    ckpt_dir = str(tmp / "ckpt")
    started = []
    try:
        specs = {"p1": (1, "--steps", STEPS), "p2": (2, "--steps", STEPS),
                 "p4": (4, "--steps", STEPS), "d1": (1, "--draws"), "d2": (2, "--draws")}
        launched = {tag: _launch(tmp, tag, world, *extra)
                    for tag, (world, *extra) in specs.items()}
        started += [p for procs, _ in launched.values() for p in procs]
        died, _ = _launch(tmp, "died", 2, "--steps", 10, "--ckpt-every", 4,
                          "--ckpt-dir", ckpt_dir, "--die-at", 6)
        started += died
        res = {tag: _finish(*launched[tag]) for tag in launched}
        assert died[1].wait(timeout=RUN_TIMEOUT) == 9, "rank 1 should die abruptly"
        try:   # the survivor waits on its next collective; reap it
            died[0].communicate(timeout=5)
        except subprocess.TimeoutExpired:
            died[0].kill()
            died[0].communicate()
        res["step_file"] = open(os.path.join(ckpt_dir, "STEP")).read()
        resumed = _launch(tmp, "resumed", 2, "--steps", 10, "--ckpt-dir", ckpt_dir,
                          "--resume")
        started += resumed[0]
        res["resumed"] = _finish(*resumed)
        return res
    finally:
        for p in started:
            if p.poll() is None:
                p.kill()
                p.communicate()


def _close(a, b, rtol=1e-9):
    np.testing.assert_allclose(a, b, rtol=rtol, atol=0)


def test_two_ranks_one_train_step_match_one_process(runs):
    one, two = runs["p1"][0], runs["p2"]
    assert [r["world"] for r in two] == [2, 2]
    for r in two:
        _close(r["losses"][0], one["losses"][0])
        _close(r["checksums"][0], one["checksums"][0])
        _close(r["rewards"][0], one["rewards"][0], rtol=1e-6)
    assert two[0]["losses"][0] == two[1]["losses"][0]
    assert two[0]["checksums"][0] == two[1]["checksums"][0]
    assert one["checksums"][0] != one["checksum_before"], "the update moved nothing"


@pytest.mark.parametrize("tag", ["p2", "p4"])
def test_twenty_steps_of_p_ranks_match_one_process(runs, tag):
    one, ranks = runs["p1"][0], runs[tag]
    assert len(one["losses"]) == STEPS and np.all(np.isfinite(one["losses"]))
    assert sum(one["resets"]) > 0, "no env restarted in the run: the reset draws untested"
    cs = [one["checksum_before"]] + one["checksums"]
    assert all(a != b for a, b in zip(cs, cs[1:])), "params should move every step"
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"] and r["checksums"] == ranks[0]["checksums"]
        _close(r["losses"], one["losses"])
        _close(r["checksums"], one["checksums"])
        _close(r["rewards"], one["rewards"], rtol=1e-6)
        assert r["resets"] == one["resets"]


@pytest.mark.parametrize("tag", ["p2", "p4"])
def test_update_diagnostics_of_p_ranks_match_one_process(runs, tag):
    """The update's diagnostics (approx KL, clip fraction, value loss and
    the gradient's norm, each a mean over the minibatches, and log_std)
    all-reduced over the ranks equal one process's over the same envs,
    float64, rtol 1e-9 (the KL, a mean of terms of about 1e-6, also atol
    1e-15); every rank reports the same."""
    one, ranks = runs["p1"][0]["diagnostics"], [r["diagnostics"] for r in runs[tag]]
    assert len(one) == STEPS
    assert all(d["approx_kl"] > 0 and d["grad_norm"] > 0 for d in one), one
    for r in ranks:
        assert r == ranks[0]
        for a, b in zip(r, one):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-9, atol=1e-15, err_msg=k)


@pytest.mark.parametrize("case", ["pool", "fresh", "pool_rot"])
def test_noise_draws_with_resets_on_one_rank_match_one_process(runs, case):
    """PPO with scan noise, every restarting env in rank 0's rows: rank 1
    restarts none and only advances its generator past the reset step's
    draws, yet both ranks equal one process.  "pool" and "fresh" run in
    float64, within rtol 1e-9 (the reward 1e-6, as above).  "pool_rot"
    runs the fast scan's megakernel, whose type is float32, at the float32
    bar: loss rtol 1e-4 atol 1e-5, checksum rtol 1e-6, reward rtol 1e-5
    (measured 4e-6, 3e-9, 3e-7).  A draw of another count would shift
    every later draw of a rank's generator, far past these bars."""
    one, ranks = runs["d1"][0]["cases"][case], [r["cases"][case] for r in runs["d2"]]
    assert sum(one["local_dones"]) > 0 and sum(one["resets"]) > 0
    assert ranks[0]["local_dones"] == one["local_dones"]
    assert not any(ranks[1]["local_dones"]), "rank 1 should restart no env"
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"] and r["checksums"] == ranks[0]["checksums"]
        assert r["resets"] == one["resets"]
        if case == "pool_rot":
            np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-4, atol=1e-5)
            _close(r["checksums"], one["checksums"], rtol=1e-6)
            _close(r["rewards"], one["rewards"], rtol=1e-5)
        else:
            _close(r["losses"], one["losses"])
            _close(r["checksums"], one["checksums"])
            _close(r["rewards"], one["rewards"], rtol=1e-6)


def test_multimap_random_starts_with_resets_on_one_rank_match_one_process(runs):
    """``make_rollout`` on three stacked tracks with ``randomize_starts``
    and pool noise, float64, the restarting envs in rank 0's rows: each
    draws its next map while rank 1 draws for none of its own.  The ranks'
    rows of the final states, scans, maps and dones equal one process's
    (rtol 1e-9; measured 0)."""
    one, ranks = runs["d1"][0]["cases"]["multimap"], [r["cases"]["multimap"]
                                                      for r in runs["d2"]]
    assert sum(one["local_dones"]) > 0 and not any(ranks[1]["local_dones"])

    def rows(key):
        return sum((r[key] for r in ranks), [])

    assert one["map_idx"] != [i % 3 for i in range(N_ENV)], "no env changed its map"
    assert rows("map_idx") == one["map_idx"] and rows("done") == one["done"]
    _close(rows("x"), one["x"])
    _close(rows("scans"), one["scans"])


def test_rank_death_and_checkpoint_resume(runs):
    one = runs["p1"][0]
    assert int(runs["step_file"]) == 4
    res = runs["resumed"]
    assert [r["start_step"] for r in res] == [4, 4]
    assert res[0]["losses"] == res[1]["losses"]
    _close(res[0]["losses"], one["losses"][4:10])
    _close(res[0]["checksums"], one["checksums"][4:10])


def _torchrun_train_ppo(tmp_path, world, flags):
    """``examples.train_ppo`` as torchrun launches it: ``world`` processes
    with ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK`` and the ``MASTER_*``
    variables -> each rank's log."""
    port = _free_port()
    procs = []
    try:
        for r in range(world):
            env = dict(os.environ, OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), WORLD_SIZE=str(world), RANK=str(r),
                       LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "red_gym_tpu_torch.examples.train_ppo", *flags],
                cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        logs = [p.communicate(timeout=RUN_TIMEOUT)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return logs


def test_train_ppo_cli_under_two_ranks_matches_one_process(tmp_path):
    """``examples.train_ppo`` under two torchrun-style ranks: rank 0's CSV
    equals the one-process run's at the float32 bar (the script trains in
    float32, and the ranks' partial sums round apart from one process's
    sums: rtol 1e-4, atol 1e-5 on the printed six decimals), and only rank 0
    logs.  Every rank writes its shard of iteration 2, env states included;
    a restart of the same command with ``--resume`` and ``--iters 3`` runs
    iteration 2 of the uninterrupted one-process run."""
    from red_gym_tpu_torch.examples import train_ppo
    from red_gym_tpu_torch.utils import checkpoint as ckpt

    flags = ["--device", "cpu", "--scan-mode", "exact", "--envs", "8", "--rollout", "4",
             "--beams", "54"]
    shards = str(tmp_path / "two_ckpt")
    logs = _torchrun_train_ppo(tmp_path, 2, flags + [
        "--iters", "2", "--save", shards, "--log-csv", str(tmp_path / "two.csv")])
    train_ppo.main(flags + ["--iters", "3", "--save", str(tmp_path / "one.pt"),
                            "--log-csv", str(tmp_path / "one.csv")])
    assert "2 ranks x 4 envs" in logs[0] and "iter 1:" in logs[0]
    assert "iter" not in logs[1] and "backend gloo" in logs[1]
    assert sorted(os.listdir(os.path.join(shards, "step-2"))) == [
        "shard-00000-of-00002.pt", "shard-00001-of-00002.pt"]
    resumed = _torchrun_train_ppo(tmp_path, 2, flags + [
        "--iters", "3", "--save", shards, "--resume",
        "--log-csv", str(tmp_path / "resumed.csv")])
    assert "state of iteration 2" in resumed[0] and "iter 0:" not in resumed[0]

    def rows(name):
        lines = open(tmp_path / name).read().splitlines()
        assert lines[0].split(",")[:6] == ["iter", "env_steps", "loss", "reward_mean",
                                          "done_rate", "speed_mean"]
        return np.array([[float(v) for v in ln.split(",")[:6]] for ln in lines[1:]])

    one, two = rows("one.csv"), np.concatenate([rows("two.csv"), rows("resumed.csv")])
    np.testing.assert_array_equal(two[:, :2], one[:, :2])   # iter, env_steps
    np.testing.assert_allclose(two[:, 2:], one[:, 2:], rtol=1e-4, atol=1e-5)
    assert ckpt.read_step(shards) == 3


# --------------------------------------------------------------------------
# in-process: the row split, the shards, and world size 1
# --------------------------------------------------------------------------

def test_process_env_slice_is_jax_arithmetic():
    from red_gym_tpu_torch.parallel import distributed as dist

    for p in range(1, 5):
        n = 16 * p
        per = n // p
        got = [dist.process_env_slice(n, p, r) for r in range(p)]
        assert got == [slice(r * per, (r + 1) * per) for r in range(p)]
        assert sorted(i for s in got for i in range(n)[s]) == list(range(n))
    assert dist.process_env_slice(12) == slice(0, 12)   # no group: one process
    for n, p in ((10, 3), (7, 2), (9, 4)):
        with pytest.raises(ValueError, match=f"{n} envs not divisible by {p} processes"):
            dist.process_env_slice(n, p, 0)


def _exact_params(cfg, tracks):
    from red_gym_tpu_torch import env as envlib
    if len(tracks) == 1:
        return envlib.make_params(cfg, tracks[0], ".png", device="cpu")
    return envlib.make_multimap_params(cfg, tracks, device="cpu")


def test_shard_envs_and_params_keep_a_ranks_rows():
    from red_gym_tpu_torch import assets, rollout
    from red_gym_tpu_torch.config import SimConfig
    from red_gym_tpu_torch.env import EnvParams
    from red_gym_tpu_torch.ops.scan_fast import RangeTexture
    from red_gym_tpu_torch.parallel import distributed as dist, sharding as sh

    cfg = SimConfig(num_agents=2, num_beams=54, dtype="float64", march_iters=8)
    track = assets.named_map_yaml("track_0019")
    params = _exact_params(cfg, [track])
    start = torch.as_tensor(assets.waypoint_start_poses(track, 2)).expand(8, 2, 3)
    poses = start + torch.linspace(0, 0.3, 8, dtype=torch.float64)[:, None, None]
    state, obs, *_ = rollout.batched_reset(cfg, params, poses, torch.Generator())
    mesh = sh.EnvMesh(world_size=2, rank=1, device=torch.device("cpu"))
    for tree in (state, obs):
        mine = sh.shard_envs(mesh, tree)
        for a, b in zip(tree, mine):
            if a is None:
                assert b is None
            else:
                assert torch.equal(b, a[4:8])
    # without a group, local_rows keeps every row (as a copy)
    whole = dist.local_rows(state, 8)
    assert torch.equal(whole.x, state.x) and whole.x.data_ptr() != state.x.data_ptr()
    with pytest.raises(ValueError, match="rows"):
        dist.local_rows(state, 6)

    # one map: every field whole
    shared = sh.shard_params(mesh, params)
    assert torch.equal(shared.tmap.dt, params.tmap.dt)
    # map_axis=0: one map an env, this rank's four
    stacked = _exact_params(cfg, [track, assets.named_map_yaml("track_0042")] * 4)
    n = stacked.tmap.dt.shape[0]
    hw = stacked.tmap.dt.shape[1:]
    rtex = RangeTexture(rt=torch.arange(n * 6 * 4.0).reshape(n, 6, 4),
                        valid=torch.ones(n, 6, dtype=torch.bool),
                        hc=torch.full((n,), 2), wc=torch.full((n,), 3),
                        cell=torch.linspace(0.1, 0.8, n), fmat=torch.eye(4),
                        gmat=torch.eye(4), smat=torch.eye(4), fmat_sw=torch.eye(4),
                        shift1=torch.eye(4), c_frac=torch.zeros(4))
    per_env = sh.shard_params(mesh, EnvParams(stacked.vehicle, stacked.tables,
                                              stacked.tmap, rtex), map_axis=0)
    assert per_env.tmap.dt.shape == (4,) + hw
    for f in stacked.tmap._fields:
        assert torch.equal(getattr(per_env.tmap, f), getattr(stacked.tmap, f)[4:8]), f
    for f in ("rt", "valid", "hc", "wc", "cell"):
        assert torch.equal(getattr(per_env.rtex, f), getattr(rtex, f)[4:8]), f
    assert torch.equal(per_env.rtex.fmat, rtex.fmat)
    with pytest.raises(ValueError, match="map_axis"):
        sh.shard_params(mesh, stacked, map_axis=1)


def test_row_draws_are_the_global_draws_rows():
    from red_gym_tpu_torch.parallel import draws

    def draw(n):
        return torch.randn((n, 3), generator=torch.Generator().manual_seed(5),
                           dtype=torch.float64)

    whole = draw(12)
    with draws.row_draws(12, 4):
        assert torch.equal(draws.draw_rows(4, draw), whole[4:8])
        with pytest.raises(ValueError, match="outside"):
            draws.draw_rows(9, draw)
    assert draws.current() is None
    assert torch.equal(draws.draw_rows(12, draw), whole)


def test_world_size_one_is_the_plain_train_step(tmp_path):
    """A group of one process (gloo): its mesh is one rank, so train_step,
    replicate and the sharded checkpoint are the one-process code:
    ``torch.equal`` to a trainer without a mesh."""
    from red_gym_tpu_torch import assets, env as envlib, rollout
    from red_gym_tpu_torch.agents.ppo import PPO, PPOConfig, ScanPolicy
    from red_gym_tpu_torch.config import SimConfig
    from red_gym_tpu_torch.parallel import distributed as dist, sharding as sh
    from red_gym_tpu_torch.utils import checkpoint as ckpt

    cfg = SimConfig(num_agents=2, num_beams=54, dtype="float64", march_iters=8,
                    scan_noise_std=0.01)
    track = assets.packaged_tracks()[0]
    params = envlib.make_params(cfg, track, ".png", device="cpu")
    poses = torch.as_tensor(assets.waypoint_start_poses(track, 2)).expand(8, 2, 3)
    runs = []
    dist.initialize(device="cpu", backend="gloo")
    try:
        assert dist.is_initialized() and dist.world_size() == 1
        dist.initialize(device="cpu")                     # a second call: a no-op
        mesh = sh.make_env_mesh(device="cpu")
        assert mesh.world_size == 1 and mesh.rank == 0
        for m in (None, mesh):
            gen = torch.Generator().manual_seed(0)
            with sh.env_draws(m, 8):
                s, o, *_ = rollout.batched_reset(cfg, params, poses, gen)
            ppo = PPO(cfg, params, PPOConfig(rollout_len=4, minibatches=2, epochs=1),
                      ScanPolicy(num_beams=54, hidden=32, scan_stride=4), mesh=m)
            ps = ppo.init(torch.Generator().manual_seed(1))
            if m is not None:
                ps = sh.replicate(m, ps)
            out = []
            for _ in range(2):
                ps, s, o, met = ppo.train_step(ps, s, o)
                out.append(met)
            if m is not None:
                ckpt.save_shards(str(tmp_path / "ck"), {"pstate": ps, "s": s}, 2, m)
                back, step = ckpt.restore_shards(str(tmp_path / "ck"),
                                                 like={"pstate": ps, "s": s}, mesh=m)
                assert step == 2 and torch.equal(back["s"].x, s.x)
            runs.append((ps, s, out))
    finally:
        dist.shutdown()
    (pa, sa, ma), (pb, sb, mb) = runs
    for a, b in zip(pa.policy.parameters(), pb.policy.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(sa.x, sb.x)
    for a, b in zip(ma, mb):
        for k in a:
            assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])), k


def test_restore_shards_needs_the_saving_world_size(tmp_path):
    from red_gym_tpu_torch.parallel import sharding as sh
    from red_gym_tpu_torch.utils import checkpoint as ckpt

    d = str(tmp_path / "ck")
    ckpt.save_shards(d, {"x": torch.arange(3)}, 7)
    assert ckpt.read_step(d) == 7
    tree, step = ckpt.restore_shards(d, like={"x": torch.zeros(3, dtype=torch.int64)})
    assert step == 7 and torch.equal(tree["x"], torch.arange(3))
    with pytest.raises(ValueError, match="world size"):
        ckpt.restore_shards(d, mesh=sh.EnvMesh(2, 0, torch.device("cpu")))


if __name__ == "__main__":
    worker()
