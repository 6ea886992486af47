#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``red_gym_tpu_torch``).

Run from the repository root on a machine with an NVIDIA GPU:

    python3 chip_smoke.py            # the whole check, one card
    python3 chip_smoke.py --profile  # also a torch.profiler kernel table

Phases, one line or more each; any failure exits non-zero before the last
line:

1. the card (nvidia-smi name and power limit);
2. build every CUDA kernel under red_gym_tpu_torch/csrc/ (nvcc);
3. env.make_params on track_0019 at the library-default texture stride 2:
   the range texture is marched on the card;
4. kernel phase: mega_edge_ttc (CUDA) against mega_edge_ttc_reference on
   the card at K = 16384 envs x 2 agents, on operands made by the main
   path's own prep from random free poses; p99 |diff| < 1e-3 m, < 0.2 % of
   beams off by more than 4 texture cells, iTTC hits equal; median times;
5. main path: rollout.batched_reset of 16384 x 2 cars at waypoint starts,
   then make_rollout with random_policy and auto-reset; the kernel's launch
   count must equal steps + reset steps; scans finite and in range;
   env-steps/s and peak device memory.

The last two lines are the kernels' JSON record and ``{"ok": true, ...}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ENVS, AGENTS, BEAMS = 16384, 2, 1080
STEPS, WARMUP_STEPS = 200, 10
TRACK = "track_0019"
TIMING_REPS = 20
P99_TOL, FAR_FRAC_TOL = 1e-3, 2e-3   # the f32 bar of tests/test_scan_fast.py
NOISE_MARGIN = 0.1                   # 10 sigma of the 1 cm scan noise


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int) -> float:
    """Median of ``reps`` single runs, each timed with CUDA events."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def random_free_poses(params, n: int, gen):
    """(n, 3) poses uniform inside random valid texture cells, random heading."""
    import torch

    rtex, tmap = params.rtex, params.tmap
    dev, dt = rtex.fmat.device, rtex.fmat.dtype
    valid = torch.nonzero(rtex.valid).squeeze(1)
    pick = valid[torch.randint(0, valid.numel(), (n,), generator=gen, device=dev)]
    wc = int(rtex.wc)
    cell = rtex.cell
    u = torch.rand((n, 3), generator=gen, device=dev, dtype=dt)
    x_rot = ((pick % wc).to(dt) + u[:, 0]) * cell
    y_rot = ((pick // wc).to(dt) + u[:, 1]) * cell
    x = x_rot * tmap.orig_c - y_rot * tmap.orig_s + tmap.orig_x
    y = x_rot * tmap.orig_s + y_rot * tmap.orig_c + tmap.orig_y
    return torch.stack([x, y, 2 * torch.pi * u[:, 2]], dim=-1)


def kernel_phase(cfg, params, dev) -> dict:
    import torch

    from red_gym_tpu_torch.ops import scan_fast, scan_kernels

    gen = torch.Generator(device=dev).manual_seed(0)
    poses = random_free_poses(params, ENVS * AGENTS, gen).reshape(ENVS, AGENTS, 3)
    vel = -2.0 + 10.0 * torch.rand((ENVS, AGENTS), generator=gen, device=dev)
    rows = torch.randint(0, cfg.noise_pool_rows, (ENVS,), generator=gen, device=dev)
    noise = params.noise_pool[rows]
    ops = scan_fast.mega_operands(poses, params.tables, params.tmap, params.rtex,
                                  cfg, noise, vel)
    if ops[-1] != torch.bfloat16:
        fail(f"e/w taps resolved to {ops[-1]}, expected bfloat16 on CUDA")
    out_k, hit_k = scan_kernels.mega_edge_ttc(*ops)
    out_r, hit_r = scan_kernels.mega_edge_ttc_reference(*ops)
    torch.cuda.synchronize()
    err = (out_k - out_r).abs()
    cell = float(params.rtex.cell)
    flat = err.flatten().sort().values
    p99 = float(flat[int(0.99 * (flat.numel() - 1))])
    far = float((err > 4 * cell).float().mean())
    max_err = float(err.max())
    n_hits = int(hit_r.sum())
    hit_diff = int((hit_k != hit_r).sum())
    say("kernel", f"K={ENVS * AGENTS} B={cfg.num_beams}: p99 |diff| {p99:.3e} m, "
        f"max {max_err:.3e} m, {100 * far:.4f}% beams > 4 cells, "
        f"{n_hits} hit rows, {hit_diff} hit mismatches")
    if not torch.isfinite(out_k).all():
        fail("kernel scan has non-finite values")
    if p99 >= P99_TOL or far >= FAR_FRAC_TOL:
        fail(f"kernel disagrees with its plain twin (p99 {p99}, far {far})")
    if hit_diff:
        bad = torch.nonzero(hit_k != hit_r).squeeze(1)[:5]
        fail(f"{hit_diff} iTTC hit flags differ from the plain twin; rows "
             f"{bad.tolist()} have max |diff| {err[bad].amax(dim=1).tolist()} m")
    if n_hits == 0:
        fail("no iTTC hits in the kernel phase: the hit comparison is vacuous")
    ms = median_ms(lambda: scan_kernels.mega_edge_ttc(*ops), TIMING_REPS)
    plain_ms = median_ms(lambda: scan_kernels.mega_edge_ttc_reference(*ops),
                         TIMING_REPS)
    say("kernel", f"median of {TIMING_REPS}: CUDA kernel {ms:.3f} ms, "
        f"plain PyTorch twin {plain_ms:.3f} ms")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def main_path(cfg, params, dev, profile: bool) -> int:
    import torch

    from red_gym_tpu_torch import assets, rollout
    from red_gym_tpu_torch.ops import scan_kernels

    start = torch.as_tensor(assets.waypoint_start_poses(TRACK, AGENTS),
                            dtype=cfg.tdtype, device=dev)
    poses = start.expand(ENVS, AGENTS, 3).contiguous()
    gen = torch.Generator(device=dev).manual_seed(1)
    policy = rollout.random_policy(cfg)
    state, obs, *_ = rollout.batched_reset(cfg, params, poses, gen)
    carry = rollout.RolloutCarry(state, obs)
    carry, _ = rollout.make_rollout(cfg, params, policy, WARMUP_STEPS)(carry, gen)
    if profile:
        profile_steps(cfg, params, policy, carry, gen)
    run = rollout.make_rollout(cfg, params, policy, STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    scan_kernels.mega_edge_ttc.launches = 0
    t0 = time.perf_counter()
    carry, outs = run(carry, gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = scan_kernels.mega_edge_ttc.launches
    peak = torch.cuda.max_memory_allocated(dev)
    resets = outs["resets"]
    n_done = int(outs["done"].sum())
    say("main", f"{STEPS} steps of {ENVS} envs x {AGENTS} agents x "
        f"{cfg.num_beams} beams in {seconds:.3f} s: "
        f"{ENVS * STEPS / seconds:.0f} env-steps/s "
        f"({1e3 * seconds / STEPS:.3f} ms/step incl. auto-reset), "
        f"peak device memory {peak / 2**30:.2f} GiB")
    say("main", f"{n_done} env episodes ended; {resets} of {STEPS} steps "
        f"reset some env; mega_edge_ttc launches {launches}")
    if launches != STEPS + resets:
        fail(f"mega_edge_ttc launched {launches} times, expected "
             f"{STEPS} steps + {resets} resets")
    scans = carry.obs.scans
    if not torch.isfinite(scans).all():
        fail("non-finite scans")
    lo, hi = float(scans.min()), float(scans.max())
    if lo < -NOISE_MARGIN or hi > cfg.max_range + NOISE_MARGIN:
        fail(f"scans outside [-{NOISE_MARGIN}, max_range + {NOISE_MARGIN}]: "
             f"[{lo}, {hi}]")
    far_beams = float((scans > 0.5).float().mean())
    say("main", f"scans in [{lo:.3f}, {hi:.3f}] m, mean {float(scans.mean()):.3f} m, "
        f"{100 * far_beams:.1f}% of beams beyond 0.5 m")
    if far_beams < 0.5:
        fail("most beams read under 0.5 m: degenerate scans")
    return launches


def profile_steps(cfg, params, policy, carry, gen) -> None:
    """Kernel time by name over a few main-path steps (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from red_gym_tpu_torch import rollout

    run = rollout.make_rollout(cfg, params, policy, 5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(carry, gen)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=25)
    for line in table.splitlines():
        print(f"[profile] {line}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also print a torch.profiler table of 5 main-path steps")
    args = ap.parse_args()
    try:
        import torch
    except ImportError as e:
        fail(f"no torch: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a GPU")
    try:
        from red_gym_tpu_torch import assets, env
        from red_gym_tpu_torch.config import SimConfig
        from red_gym_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"cannot import red_gym_tpu_torch ({e}): run from the repository root")

    smi = nvidia_smi()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    say("device", f"{kind}; nvidia-smi: {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    for name in _build.kernel_names():
        lib = _build.build(name)
        with open(lib + ".log") as f:
            report = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
        say("build", f"{name} -> {os.path.relpath(lib)}; " + " | ".join(report))
    say("build", f"nvcc build of {len(_build.kernel_names())} kernel(s): "
        f"{time.perf_counter() - t0:.1f} s")

    # a cold texture build every run: its time is one of the reported numbers
    os.environ["RED_GYM_TPU_TEXTURE_CACHE"] = "off"
    cfg = SimConfig(num_agents=AGENTS, num_beams=BEAMS, scan_mode="fast")
    t0 = time.perf_counter()
    params = env.make_params(cfg, assets.named_map_yaml(TRACK), device=dev)
    torch.cuda.synchronize()
    rt = params.rtex.rt
    say("texture", f"{TRACK} stride {cfg.rt_pose_stride}: {int(params.rtex.hc)}x"
        f"{int(params.rtex.wc)} cells, rt {tuple(rt.shape)} {rt.dtype} "
        f"({rt.numel() * rt.element_size() / 1e6:.0f} MB); make_params (map, "
        f"EDT, texture marched on the card) {time.perf_counter() - t0:.1f} s")

    kern = kernel_phase(cfg, params, dev)
    launches = main_path(cfg, params, dev, args.profile)

    record = {"name": "mega_edge_ttc", "route": "cuda",
              "source": "red_gym_tpu_torch/csrc/mega_edge_ttc.cu",
              "replaces": "red_gym_tpu/ops/pallas_scan.py:1027",
              "launches": launches, **kern}
    print(json.dumps({"kernels": [record]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
