#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``red_gym_tpu_torch``).

Run from the repository root on a machine with an NVIDIA GPU:

    python3 chip_smoke.py            # the whole check, one card
    python3 chip_smoke.py --profile  # also a torch.profiler kernel table

Phases, one line or more each; any failure exits non-zero before the last
line:

1. the card (nvidia-smi name and power limit);
2. build every CUDA kernel under red_gym_tpu_torch/csrc/ (one nvcc each, in
   parallel);
3. env.make_params on track_0019 at the library-default texture stride 2:
   the range texture is marched on the card, and so is the 1-channel
   texture that the legacy and ultra configs read; the default texture
   again, stored in float32, with its rays marched by the march kernel and
   then by its twin (the disk cache off): rt and valid torch.equal, both
   build times;
4. kernel phases at K = 16384 envs x 2 agents, each kernel against its
   plain PyTorch twin on the card, with median CUDA-event times of both
   (``median_ms``: R calls back to back between one pair of events, R = 10
   for calls under 2 ms, so that the wrapper's host time hides behind the
   card's work as it does on a path; the same for kernel, twin and library
   call), the kernel's own time on the device (``device_ms``: the median
   duration of its device kernels under torch.profiler over 60 launches,
   without the wrapper's host time) and its registers and spill bytes from
   its ptxas report:
   - march (csrc/march.cu, the exact scan's sphere march; it replaces the
     JAX package's lax.while_loop, no TPU kernel), beams form, on random
     free poses of the map, float32: every range torch.equal to the twin,
     and so with march_iters=40 and in float64 on 1024 envs x 2 agents;
     the iterations a ray (mean, p99, max) from an eager replay of the
     twin's march body, whose ranges must equal the kernel's too; its bound
     counts the kernel's operations a counted iteration at the float32
     rate against its bytes;
   - mega_edge_ttc, plain, on operands made by the main path's own prep
     from random free poses; the call launches the spectra kernel and the
     render kernel, and each is also timed alone (``spectra_ms``,
     ``render_ms``), with the spectra kernel's own bound (float64
     operations over the card's float64 rate, or bytes);
   - mega_edge_ttc with opponents (slab noise), and with opponents and the
     pool_rot resident pool (offset rows - 37), the second car of each env
     placed within 2.5 m of the first; some beams must be shortened;
   - the scan bar: p99 |diff| < 1e-3 m, < 0.2 % of beams off by more than
     4 texture cells, iTTC hits equal;
   - prestep (the pre-scan state kernel) on random in-range states and
     actions: all five outputs bit-equal to the twin; beside its times the
     device time of an empty kernel of its grid and block (``floor_ms``)
     and its wrapper's host time a call (``host_us``: ``host_us``, 200
     calls behind ``torch.cuda._sleep`` on the host clock);
   - the four epilogue kernels of the unfused scan (theta_shuffle_blend
     and its edge, edge + iTTC and edge + iTTC + opponent forms) on the
     rolled spectra of the bilinear config's prep chain, cars within 2.5 m
     of each other; the scan bar (hits where a kernel has them); the
     opponent form must shorten some beams;
   - theta_spectral_ttc (kernel 5, the spectral render with noise and
     iTTC) on the spectra of the ultra config's prep chain (the real-valued
     roll), cars within 2.5 m of each other; the scan bar and equal hits;
   - beside each kernel its bound (the larger of its operations over the
     card's float32 peak and its bytes over the memory rate, from this
     run's operands) and, where one PyTorch call computes its arithmetic,
     that call's median time (kernel 7: spec_r @ gmat; kernel 5:
     torch.matmul(spec_r, smat); the product only), and for those two the
     SM clock and power that nvidia-smi reads while each runs;
5. main paths, each rollout.batched_reset of 16384 x 2 cars at waypoint
   starts, 10 warm-up steps, then timed make_rollout steps with
   random_policy and auto-reset; every kernel's launch count (set to 0 just
   before) must equal steps + reset steps where the path runs it and 0
   elsewhere; scans finite and in range; env-steps/s and peak memory:
   - default: prestep + megakernel with opponents, pool noise;
   - pool_rot: the same with noise_mode="pool_rot";
   - eager prestate: state_kernel="off", fuse_scan_opp="off" (the plain
     megakernel and the eager chain around it);
   - bilinear (bench.py's mode): the prep chain and the edge epilogue with
     noise, iTTC and opponents;
   - bilinear_opp_off: the edge epilogue with noise and iTTC, then the
     eager opponent pass;
   - bilinear_ttc_off: the edge epilogue alone, then the eager noise add,
     iTTC check and opponent pass;
   - legacy (bench.py's mode: bilinear, occlusion off, no grad channels,
     a 1-channel texture marched on the card): the plain 3-tap epilogue
     and the eager tail;
   - ultra (bench.py's ultra/ultrafused: spectral theta, nearest1,
     occlusion off, no grad channels, on the legacy texture): the prep
     chain with the real-valued roll, kernel 5, the eager opponent pass;
   - ultra_ttc_off: the plain spectral render (torch.matmul), then the
     eager noise add, iTTC check and opponent pass; no kernel;
   - exact (scan_mode="exact", SimConfig's default; no texture): the eager
     pre-scan chain, the march kernel's beams form, the eager noise add,
     iTTC check and opponent pass; if a warm-up step takes more than 50 ms
     it times proportionally fewer steps, at least 20, and says so;
6. multi-map batches (examples/train_ppo.py --multi-map): all 11 packaged
   tracks stacked by env.make_multimap_params (each map padded to the
   largest, 952 x 947 px; each texture built on its raw map by the march
   kernel, padded and stacked), with its set-up seconds (the exact params:
   11 EDTs and the stacking; the fast params: that and 11 texture builds);
   env e on map e % 11, both cars at that track's waypoint rows 0 and 8;
   - the march kernel's stacked form at ENVS x AGENTS x BEAMS on random
     free poses of each env's map: torch.equal to its twin in float32, with
     march_iters=40 and in float64 (MARCH_F64_ENVS envs), iterations a ray,
     times, registers and bound; and the envs of each map torch.equal to
     the same poses marched on that map alone;
   - the megakernel with opponents on the stacked texture (the flat
     (11 x N, 640) view) against its twin at the scan bar, hits equal; and
     the rows of each map's envs torch.equal to the same poses, speeds,
     noise rows and opponents run on that map alone (its own params);
   - four main paths with auto-reset onto a uniformly drawn track and its
     start (make_rollout's randomize_starts), prestep launched 0 times on
     each: multimap (the default config: the eager pre-scan chain and the
     megakernel with opponents), multimap_bilinear (kernel 4),
     multimap_ultra (train_ppo.py --ultra --multi-map: kernel 5) and
     multimap_exact (the march kernel's stacked form);
7. PPO training (``red_gym_tpu_torch.examples.train_ppo``'s config and
   ``agents.ppo.PPO``: ScanPolicy(hidden=256, scan_stride=8), rollout 32,
   4 minibatches, 2 epochs), launch counts set to 0 before and read after
   each:
   - ppo: the trainer's default scan (fast, bilinear, edge + grad channels,
     pool noise; kernel 4) on track_0019, one warm-up train_step, then 3
     timed ones: collect env-steps/s, update ms, iteration env-steps/s and
     peak memory; the loss finite, the params changed, kernel 4 launched
     collect steps + reset steps times, prestep and every other kernel 0;
     the update's diagnostics (approx KL, clip fraction, log_std, value
     loss, gradient norm) of each timed iteration printed and finite; each
     rollout's action noise the last one's shifted by the epochs (JAX's
     key chain); then train_ppo --multi-map at the seed runner's flags
     (``ppo_seeds.trainer_flags``) for REPRO_PPO_ITERS iterations of seed
     0, twice: every CSV column but the wall time equal;
   - ppo_ultra: one iteration of --ultra, kernel 5 counted the same way;
   - ppo_multimap_pursuit: one iteration on the 11 stacked tracks with
     pure_pursuit_opponents_multi (kernel 4); the opponents of the envs
     that did not restart moved forward along their own raceline; the
     pursuit step's own peak memory under 2 GiB;
   - checkpoint: a PPOState and an EnvState saved and restored on the card
     (utils.checkpoint) torch.equal to what was saved, then a 200-step
     mean-policy rollout (train_ppo --eval) with its speed, crash rate and
     laps.

8. the gym surface, launch counts set to 0 before and read after each:
   - [vec_env]: ``red_gym_tpu_torch.make_vec(track_0019, 16384,
     num_agents=2, scan_mode="fast", return_final_obs=True)`` (the library
     defaults: prestep + the megakernel with opponents, pool noise), reset
     at the waypoint starts, then random actions within the vehicle's action
     bounds from a seeded generator: 10 warm-up steps, 200 timed steps
     (env-steps/s, ms a step, peak memory, reset steps; the two kernels
     launched once a step and once a reset step, every other kernel 0),
     50 steps with every result copied to numpy as the gymnasium vector
     facade does (``vec_env.numpy_step``), then 20 steps against a hand
     loop of ``env.step`` + ``rollout.reset_done`` on a generator of the
     same state: observations, rewards, dones, ``final_obs`` and states
     torch.equal, with some reset step among them;
   - [debug]: ``utils.debug.check_state`` on those states all zeros; NaN in
     ``x`` and in ``start_pose`` on 1 % of the envs, then
     ``quarantine_reset`` flags exactly those, restarts them finite and
     leaves every other env torch.equal, and ``check_state`` is all zeros
     again;
   - [gym_compat]: ``gym_compat.make("f110_gym:f110-v0", map=track_0019,
     num_agents=2)`` (one env, SimConfig's default exact scan, on the card)
     through 1000 legacy 4-tuple steps, both cars driven by
     ``agents.pure_pursuit.plan`` on the host (the reference's
     waypoint_follow.py loop): no collision flag, the ego advanced along the
     raceline, the march kernel launched once a step and once for the reset,
     steps/s (one env: host-bound).

9. the bitmap-SAC stack, launch counts set to 0 before and read after
   each:
   - [rasterize]: the rasterizer's kernels (csrc/rasterize.cu; they replace
     XLA's fused broadcast of red_gym_tpu/ops/rasterize.py, no TPU kernel)
     on 64 scans of 1080 beams from the exact scan at random free poses of
     track_0019, 600 beams drawn on 256 x 256: the fill, the polygon
     outline and the rays torch.equal to their twins on the card; the
     outline's runs of one pixel along its samples and its distinct pixels
     an image (the twin's arithmetic, on the host); times at 64 images and
     at one, bounds (the least work counted from this run's crossings and
     segments), registers and spills; lidar_to_bitmap in FILL, POLYGON and
     RAYS on the card equal to the same call on the CPU (4 images);
   - [sac_bitmap]: train_sac_bitmap_scale's trainer at its defaults (64
     envs, 256 px, bf16 CNN, batch 64, a 25,000-transition uint8 replay,
     reward_mode "fixed"): one warm-up iteration and one update iteration
     of 32 steps; the fill, segment and march kernels launched once a
     planning step and once a reset step, every other kernel 0; losses
     and rewards finite; the update iteration's SAC diagnostics (twin-Q
     minimum, log-probability, log_std, the three gradient norms before
     the clip; means over its steps) printed and finite; the replay's size
     and ptr; collection
     env-steps/s, ms a SAC update, peak memory; a torch.profiler summary
     of 3 planning steps (device ops, busy and wall ms a step); then the
     trainer's main() at the seed runner's flags (32 envs, 128 px, float32
     CNN) for REPRO_BITMAP_ITERS iterations of seed 0, twice: every CSV
     column but the time equal, each iteration's seconds printed;
   - [sac_scale]: train_sac_scale's trainer at 512 envs x 1080 beams
     (spectral fast scan): one warm-up and one update iteration; kernel 5
     launched once a step and once a reset step; losses finite; the SAC
     diagnostics as in [sac_bitmap]; env-steps/s;
   - [sac]: train_sac (one env) for 60 steps, updates every 10 after 20;
     the kernels once a step and once a reset; its checkpoint restored
     torch.equal and the restored actor's mean action equal.

10. the tooling tier, launch counts set to 0 before and read after
   each (phase 3 also runs [edt] on the 14 maps before the main paths):
   - [edt]: kernel E (csrc/edt.cu; it replaces XLA's min-plus passes of
     red_gym_tpu/ops/edt.py, no TPU kernel) on the 11 packaged tracks,
     berlin, skirk and the generated track: torch.equal to its twin on the
     card and within scipy's bar (rtol 1e-6, atol 1e-5); on track_0019 and
     the largest map its times, each of its two kernels' device ms, bound
     (the uint8 mask read and the output written, against the linear
     operations of a row pass and a per-column lower envelope; D1's round
     trip apart), registers, spills and scipy's host seconds; on three long-search grids (2048 x 2048 walled only on its
     border, 2048 x 2048 with one zero pixel, 1024 x 1024 all free)
     torch.equal to its twin and each kernel's device ms;
   - [trackgen]: maps.trackgen.generate(seed 0) on the host, load_map with
     edt_backend="device" (kernel E once) and the texture marched on the
     card, then the default path for 200 steps from the generated CSV's
     waypoint starts: kernels 1a and 2 once a step and reset step;
   - [param_search]: tuning.search at examples/param_search_cma.py's width
     (popsize 50, 64 beams, float32 exact scan, RK4, dt 0.01, march_iters
     32, no noise) on track_0019, one generation of 500 steps (cut from the
     example's 15 x 4500): the march kernel once a step and the reset step,
     every other kernel 0, fitness finite, ms a step, rollouts/s and a
     torch.profiler summary of 5 steps; the march kernel torch.equal to its
     twin on the final poses of a 300-step float32 race of 50 candidates;
     the evaluator in float64 at popsize 4 x 200 steps on the card and the
     CPU: final state, scans, lap times and fitness within 1e-9, toggles
     and crash flags equal (200 steps finish no lap, so the fitness alone
     is the budget plus a penalty);
   - [fast64]: the default config in float64 (texture marched in float64 by
     the march kernel) for 50 timed steps at 16384 x 2 x 1080, no scan
     kernel (JAX launches no Pallas kernel there either), the first 256
     envs' scans within 1e-9 m of the CPU's; scan_backend="xla" in float32
     for 50 steps, no scan kernel, one step at the float32 scan bar against
     the default path's step (e/w taps in float32) from the same state;
   - [export]: the PPO phase's ScanPolicy(hidden=256) head exported with a
     symbolic batch, saved and loaded (utils.export): 16384 scans served
     within 1e-6 of the direct head, ms a batch, batches of 1 and 7; a
     200-step race driven by the loaded program; the SAC phase's actor
     through the same round trip;
   - [collect_lidar]: examples/collect_lidar_dataset.py at its defaults (64
     episodes x 10 steps, 256 px): march, fill and segment kernels launched
     as expected, the npz with JAX's keys, shapes and dtypes.

11. after the phases of the rest of the package ([trace_fast],
   [distributed], [profile_components], [scan_error], [generalization],
   [mpc_demo], [lidar_bitmap]), [draws]: the laws of every random draw of
   the port (D1-D9 below: the noise pool, pool picks, pool_rot offsets and
   its reset step, fresh and exact-scan noise, randomize_starts' maps,
   random_policy, PPO's noise and permutations, SAC's eps and replay
   indices) on the card at the main path's sizes, each statistic beside
   its bar (``draws_phase``); any miss fails.

``--profile`` adds torch.profiler summaries (device kernels and device
busy time per step) of the default, eager, bilinear, ultra and exact
paths, of the four multi-map paths and of [vec_env] and [gym_compat], tables of the default, bilinear,
ultra, exact, multimap and multimap_exact paths' kernels by device time,
and the trainer's split of one iteration by section (``[profile]`` line of
train_ppo.profile_iteration).

The last two lines are the kernels' JSON record (with each kernel's
launches on the other phases that run it: ``vec_env_launches``,
``gym_compat_launches``, ``trackgen_launches``, ``param_search_launches``,
``collect_lidar_launches``; kernel E's record with each timed map under
``maps``) and ``{"ok": true, ...}``.  Nothing here imports
gymnasium or matplotlib.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import time

ENVS, AGENTS, BEAMS = 16384, 2, 1080
STEPS, WARMUP_STEPS = 200, 10
TRACK = "track_0019"
TIMING_REPS = 20
DEVICE_CALLS = 60        # launches under torch.profiler for a kernel's device time
DEVICE_WINDOWS = 4       # profiler windows at most to see them all
HOST_CALLS = 200         # calls timed on the host clock for a wrapper's host time
SLEEP_CYCLES = 50_000_000  # torch.cuda._sleep ahead of each host batch (~25 ms)
P99_TOL, FAR_FRAC_TOL = 1e-3, 2e-3   # the f32 bar of tests/test_scan_fast.py
NOISE_MARGIN = 0.1                   # 10 sigma of the 1 cm scan noise
# published H100 SXM peaks, the card's fastest rate for each type: float32
# FMAs outside the tensor cores (TF32 is another type), bf16 and float64 on
# the tensor cores (float64 MMA rounds each product and sum as IEEE float64
# does), and the HBM3 rate
F32_FLOPS, BF16_FLOPS, F64_FLOPS, HBM_BYTES_PER_S = 67e12, 989e12, 67e12, 3.35e12
# prestep's operations a row, counted high (steer delay, PID, four
# single-track evaluations of RK4, cell lookup): even so they take less
# time than its bytes, so bytes bound it
PRESTEP_OPS_PER_ROW = 1000
# the march kernel's (csrc/march.cu) operations, from the source: a
# ray-iteration of march_ray is the end test (2 compares), the step (2
# multiplies, 2 adds), dt_lookup (2 subtractions, a negation, 4 multiplies,
# 2 adds, 4 compares, 2 divisions, 2 float-to-int casts) and the running
# total (1 add); theta_index is 12 (subtract, multiply, two floored
# remainders of 3, the offset's multiply, add and 2 casts).  None is a fused
# multiply-add, so each counts as one lane instruction at 128 a cycle an SM,
# LANE_OPS_PER_S: half of F32_FLOPS, which counts an FMA as two.  Divisions
# and casts issue slower still, so the bound is a floor.
MARCH_OPS_PER_ITER, THETA_INDEX_OPS = 24, 12
LANE_OPS_PER_S = F32_FLOPS / 2
MARCH_STEP_MS = 50.0     # the exact path times fewer steps above this a step
MARCH_F64_ENVS = 1024


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
    """Time of one call of ``fn``: the median over ``reps`` windows, each of
    R calls back to back between one pair of CUDA events, divided by R.
    R = 10 for a call under 2 ms (one call timed alone, after a warm-up
    call, decides), else 1: the host enqueues the next calls while the card
    runs, so a wrapper's host time before its launch is not counted in
    front of an idle card."""
    import torch

    def window(r: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(r):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / r

    fn()
    r = 10 if window(1) < 2.0 else 1
    times = sorted(window(r) for _ in range(reps))
    return times[len(times) // 2]


def device_ms(fn, kernels: tuple[str, ...], calls: int = DEVICE_CALLS) -> dict:
    """The card's own time of one call of ``fn``, without the wrapper's
    host time: {name: ms}, the median duration of the device kernels whose
    names contain each of ``kernels`` over at least ``calls`` launches, and
    their sum under "total" (a call that launches two kernels, as the
    megakernel does, takes both).  The calls run in windows of ``calls``
    under torch.profiler, a window more while the profiler has dropped
    kernel records (it drops some now and then), at most DEVICE_WINDOWS."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    durs = {name: [] for name in kernels}
    fn()
    torch.cuda.synchronize()
    for _ in range(DEVICE_WINDOWS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                for name in kernels:
                    if name in e.name:
                        durs[name].append(e.time_range.elapsed_us())
        if min(len(d) for d in durs.values()) >= calls:
            break
    out = {}
    for name, d in durs.items():
        if len(d) < calls:
            fail(f"the profiler saw {len(d)} launches of {name} in "
                 f"{DEVICE_WINDOWS} windows of {calls} calls")
        d.sort()
        out[name] = d[len(d) // 2] / 1e3
    out["total"] = sum(out.values())
    return out


def host_us(fn, calls: int = HOST_CALLS, batch: int = 20) -> float:
    """Host time of one call of ``fn`` in microseconds: the median over
    ``calls // batch`` batches of ``batch`` calls, each batch timed with
    time.perf_counter while enqueued behind torch.cuda._sleep, so that the
    host never waits on the card."""
    import torch

    for _ in range(batch):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls // batch):
        torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        times.append((time.perf_counter() - t0) / batch)
        torch.cuda.synchronize()
    times.sort()
    return 1e6 * times[len(times) // 2]


def clock_under_load(fn, ms: float, seconds: float = 0.5) -> str:
    """nvidia-smi's SM clock, its maximum and the power draw, read while
    ``fn`` (about ``ms`` a call) runs back to back for about ``seconds``."""
    import torch

    for _ in range(max(1, int(1e3 * seconds / ms))):
        fn()
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    torch.cuda.synchronize()
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 else "not read"


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


def map_free_poses(tmap, n: int, gen):
    """(n, 3) poses of tmap's dtype: uniform inside random map cells with
    more than 0.2 m to the nearest obstacle, random heading."""
    import torch

    dev, dt = tmap.dt.device, tmap.dt.dtype
    free = torch.nonzero(tmap.dt.reshape(-1) > 0.2).squeeze(1)
    pick = free[torch.randint(0, free.numel(), (n,), generator=gen, device=dev)]
    w = tmap.dt.shape[1]
    u = torch.rand((n, 3), generator=gen, device=dev, dtype=dt)
    x_rot = ((pick % w).to(dt) + u[:, 0]) * tmap.resolution
    y_rot = ((pick // w).to(dt) + u[:, 1]) * tmap.resolution
    x = x_rot * tmap.orig_c - y_rot * tmap.orig_s + tmap.orig_x
    y = x_rot * tmap.orig_s + y_rot * tmap.orig_c + tmap.orig_y
    return torch.stack([x, y, 2 * torch.pi * u[:, 2]], dim=-1)


def close_poses(params, e_n: int, a_n: int, gen):
    """(e_n, a_n, 3) poses: car 0 of each env in a random free cell, the
    others within 2.5 m of it, random headings, so that cars see each other."""
    import torch

    base = random_free_poses(params, e_n, gen)
    dev, dt = base.device, base.dtype
    shift = 5.0 * torch.rand((e_n, a_n - 1, 2), generator=gen, device=dev, dtype=dt) - 2.5
    head = 2 * torch.pi * torch.rand((e_n, a_n - 1, 1), generator=gen, device=dev, dtype=dt)
    others = torch.cat([base[:, None, :2] + shift, head], dim=-1)
    return torch.cat([base[:, None], others], dim=1)


def random_states(params, shape, gen):
    """In-range inputs of the state kernel for cars of ``shape``: x (..., 7)
    at free poses, |v| < 0.5 for a fifth of them (the kinematic branch),
    steer_buf (..., 2), steer_cnt (...) int32 in 0..2, actions (..., 2)."""
    import torch

    n = 1
    for d in shape:
        n *= d
    poses = random_free_poses(params, n, gen)
    dev, dt = poses.device, poses.dtype

    def u(lo, hi, *extra):
        return lo + (hi - lo) * torch.rand((n, *extra), generator=gen, device=dev, dtype=dt)

    vel = torch.where(u(0, 1) < 0.2, u(-0.5, 0.5), u(-3.0, 10.0))
    x = torch.stack([poses[:, 0], poses[:, 1], u(-0.4, 0.4), vel, poses[:, 2],
                     u(-2.0, 2.0), u(-0.3, 0.3)], dim=-1)
    cnt = torch.randint(0, 3, (n,), generator=gen, device=dev, dtype=torch.int32)
    act = torch.stack([u(-0.5, 0.5), u(-3.0, 10.0)], dim=-1)
    return (x.reshape(*shape, 7), u(-0.4, 0.4, 2).reshape(*shape, 2),
            cnt.reshape(shape), act.reshape(*shape, 2))


def blend_operands(cfg, params, poses, gen) -> dict:
    """Keyword operands of the four epilogue kernels of ``blend_kernels``
    for poses (E, A, 3), by name: the rolled spectra of the slice's own prep
    chain (``scan_fast.rolled_spectra`` in cfg, an edge config), speeds in
    [-2, 8) m/s, one noise pool row per env and, for two or more agents,
    the opponent packs.  Kernel 7 takes the range spectra."""
    import torch

    from red_gym_tpu_torch.ops import agent_scan, collision, scan_fast

    e_n, a_n = poses.shape[:2]
    dev, t_bins = poses.device, cfg.rt_theta_bins
    sp = scan_fast.rolled_spectra(poses, params.tmap, params.rtex, cfg)
    spec = sp.spec_r.reshape(-1, 3, t_bins)
    vel = -2.0 + 10.0 * torch.rand((e_n * a_n,), generator=gen, device=dev)
    rows = torch.randint(0, cfg.noise_pool_rows, (e_n,), generator=gen, device=dev)
    render = dict(f_s=sp.f_s.reshape(-1), wsum=sp.wsum.reshape(-1), gmat=params.rtex.gmat,
                  c_frac=params.rtex.c_frac, max_range=cfg.max_range)
    edge = dict(render, spec_r=spec[:, 0], spec_e=spec[:, 1], spec_w=spec[:, 2],
                ew_dtype=scan_fast.resolve_ew_dtype(cfg, torch.float32, dev))
    ttc = dict(edge, vel=vel, noise=params.noise_pool[rows],
               cosines=params.tables.beam_cosines, side_dist=params.tables.side_distances,
               ttc_thresh=cfg.ttc_thresh, agents_per_env=a_n)
    ops = {"theta_shuffle_blend": dict(render, spec_r=spec[:, 0]),
           "theta_shuffle_blend_edge": edge, "theta_shuffle_blend_edge_ttc": ttc}
    if a_n >= 2:
        verts = collision.get_vertices(poses, params.vehicle.length, params.vehicle.width)
        opp = agent_scan.opponent_slab_scalars(poses, verts, params.tables)
        ops["theta_shuffle_blend_edge_ttc_opp"] = dict(
            ttc, sines=params.tables.beam_sines, opp=opp.reshape(e_n * a_n, -1))
    return ops


def scan_bar(label: str, out_k, hit_k, out_r, hit_r, cell: float) -> float:
    """The float32 scan bar of kernel against twin; returns max |diff|.
    Kernels without iTTC pass hit_k = hit_r = None."""
    import torch

    err = (out_k - out_r).abs()
    flat = err.flatten().sort().values
    p99 = float(flat[int(0.99 * (flat.numel() - 1))])
    n_far = int((err > 4 * cell).sum())
    far = n_far / err.numel()
    max_err = float(err.max())
    hits = ""
    if hit_r is not None:
        n_hits = int(hit_r.sum())
        hit_diff = int((hit_k != hit_r).sum())
        hits = f", {n_hits} hit rows, {hit_diff} hit mismatches"
    say("kernel", f"{label}: K={out_k.shape[0]} B={out_k.shape[1]}: p99 |diff| "
        f"{p99:.3e} m, max {max_err:.3e} m, {n_far} beams ({100 * far:.4f}%) > 4 cells{hits}")
    if not torch.isfinite(out_k).all():
        fail(f"{label}: kernel scan has non-finite values")
    if p99 >= P99_TOL or far >= FAR_FRAC_TOL:
        fail(f"{label}: kernel disagrees with its plain twin (p99 {p99}, far {far})")
    if hit_r is None:
        return max_err
    if hit_diff:
        bad = torch.nonzero(hit_k != hit_r).squeeze(1)[:5]
        fail(f"{label}: {hit_diff} iTTC hit flags differ from the plain twin; rows "
             f"{bad.tolist()} have max |diff| {err[bad].amax(dim=1).tolist()} m")
    if n_hits == 0:
        fail(f"{label}: no iTTC hits: the hit comparison is vacuous")
    return max_err


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(moved: int, f32: float = 0.0, bf16: float = 0.0, f64: float = 0.0,
          lane: float = 0.0) -> dict:
    """The least time the card could take: the larger of the operations
    (float32, bf16-input and float64 ones, each type over the card's peak
    rate for it, and ``lane`` operations that are one lane instruction each,
    at LANE_OPS_PER_S, summed) and the bytes (each input read once, each
    output written once) over the memory rate."""
    ops_ms = 1e3 * (f32 / F32_FLOPS + bf16 / BF16_FLOPS + f64 / F64_FLOPS
                    + lane / LANE_OPS_PER_S)
    bytes_ms = 1e3 * moved / HBM_BYTES_PER_S
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


# the kernel function (in ptxas's report of its library) of each kernel
# record, in the instance its path launches: bf16 texture and noise, 16-byte
# copies at B = 1080; the megakernel is a spectra kernel (<texture type>)
# and a render kernel whose variants are instances of their own
# (<opponents, pool_rot, noise type>)
MEGA_SPECTRA = "mega_spectra_kernel<__nv_bfloat16>"
MEGA_DEVICE = ("mega_spectra_kernel", "mega_render_kernel")  # a call's two kernels
KERNEL_FUNCTIONS = {
    "mega_edge_ttc": ("mega_edge_ttc", "mega_render_kernel<false, false, __nv_bfloat16>"),
    "mega_edge_ttc+opp": ("mega_edge_ttc", "mega_render_kernel<true, false, __nv_bfloat16>"),
    "mega_edge_ttc+opp+pool_rot": ("mega_edge_ttc",
                                   "mega_render_kernel<true, true, __nv_bfloat16>"),
    "prestep": ("prestep", "prestep_kernel"),
    "theta_shuffle_blend_edge_ttc": ("theta_blend", "theta_blend_kernel<1, __nv_bfloat16>"),
    "theta_shuffle_blend_edge_ttc_opp": ("theta_blend",
                                         "theta_blend_kernel<2, __nv_bfloat16>"),
    "theta_shuffle_blend_edge": ("theta_blend", "theta_blend_kernel<0, float>"),
    "theta_shuffle_blend": ("theta_blend", "theta_shuffle_blend_kernel<true>"),
    "theta_spectral_ttc": ("theta_spectral", "theta_spectral_kernel<__nv_bfloat16, true>"),
    "march": ("march", "march_beams_kernel<float>"),
    "march+stacked": ("march", "march_beams_stacked_kernel<float>"),
    "fill_polygon": ("rasterize", "fill_polygon_kernel"),
    "draw_segments": ("rasterize", "draw_segments_kernel<true, 14>"),
    "edt": ("edt", "edt_col_kernel"),
}


def resources(reports: dict, name: str, fn: str | None = None) -> dict:
    """{"regs", "spill_bytes"} of kernel record ``name`` (or of function
    ``fn`` of its library) from the ptxas reports {library: report}."""
    lib, record_fn = KERNEL_FUNCTIONS[name]
    fn = fn or record_fn
    if fn not in reports[lib]:
        fail(f"{name}: no {fn} in the ptxas report of {lib}: {sorted(reports[lib])}")
    return reports[lib][fn]


def timed(label: str, kernel, plain, lims: dict, res: dict, functions: tuple[str, ...],
          library=None) -> dict:
    """Median times of the kernel, its plain twin and, where one PyTorch
    call computes the kernel's arithmetic, that call (event windows,
    ``median_ms``), the kernel's device time (``device_ms`` of the device
    kernels named ``functions``, their sum and, under
    ``device_ms_by_kernel``, each), beside the bound and the kernel's
    registers and spills."""
    ms = median_ms(kernel, TIMING_REPS)
    dev = device_ms(kernel, functions)
    dev_ms = dev.pop("total")
    plain_ms = median_ms(plain, TIMING_REPS)
    library_ms = None if library is None else median_ms(library, TIMING_REPS)
    lib = "" if library is None else f", library call {library_ms:.3f} ms"
    regs = (f"; {res['regs']} registers, {res['spill_bytes']} spill bytes" if res
            else "")
    say("kernel", f"{label}: median of {TIMING_REPS}: CUDA kernel {ms:.4f} ms, "
        f"on the device {dev_ms:.4f} ms (profiler, median of >= {DEVICE_CALLS} launches), "
        f"plain PyTorch twin {plain_ms:.3f} ms{lib}; bound {lims['bound_ms']:.4f} ms "
        f"by {lims['bound_by']}{regs}")
    return {"ms": ms, "device_ms": dev_ms, "device_ms_by_kernel": dev, "plain_ms": plain_ms,
            **lims, "library_ms": library_ms, **res}


def tap_work(k_n: int, t_bins: int, b_n: int, ew_dtype) -> dict:
    """Operations of the seven (T x B) tap products of K rows, by type: the
    three range taps in float32, the four e/w taps bf16 x bf16 -> float32
    under a bf16 ew_dtype."""
    import torch

    tap = 2.0 * k_n * t_bins * b_n
    if ew_dtype == torch.bfloat16:
        return {"f32": 3 * tap, "bf16": 4 * tap}
    return {"f32": 7 * tap}


def mega_bound(ops, out, hit) -> dict:
    """The megakernel's bound: per row seven (T x B) tap products
    (tap_work) and the packed rfft of three rows (T x T each, float64);
    its bytes are the K gathered texture rows, the per-row and constant
    operands, the noise slab or pool, and the scan and hits written
    once."""
    k_n, t_bins, b_n = ops["rows"].shape[0], ops["t_bins"], ops["c_frac"].shape[0]
    rt = ops["rt"]
    moved = k_n * rt.shape[1] * rt.element_size() + nbytes(
        ops["rows"], ops["scal"], ops["noise"], ops["fmat"], ops["gmat"], ops["c_frac"],
        ops["cosines"], ops["side_dist"], ops.get("sines"), ops.get("opp"),
        ops.get("pool_off"), out, hit)
    return bound(moved, f64=2.0 * k_n * 3 * t_bins * t_bins,
                 **tap_work(k_n, t_bins, b_n, ops["ew_dtype"]))


def spectra_bound(ops) -> dict:
    """The spectra kernel's own bound: the packed rfft of three rows per
    row (T x T each) in float64 over the card's float64 rate; its bytes are
    the K gathered texture rows, the per-row and constant operands, and the
    rolled spectra and per-row f_s, wsum and vel it writes."""
    k_n, t_bins = ops["rows"].shape[0], ops["t_bins"]
    rt = ops["rt"]
    moved = k_n * rt.shape[1] * rt.element_size() + nbytes(
        ops["rows"], ops["scal"], ops["fmat"]) + 4 * k_n * (3 * t_bins + 3)
    return bound(moved, f64=2.0 * k_n * 3 * t_bins * t_bins)


def mega_stage_times(label: str, ops, reports, n_opp: int) -> dict:
    """The spectra kernel and the render kernel of one call, each timed
    alone (the render on the spectra that a spectra launch left in the
    workspace), the spectra kernel's bound, and each kernel's registers,
    spills and resident blocks a SM."""
    import torch

    from red_gym_tpu_torch.ops import scan_kernels

    ws = scan_kernels.mega_workspace(ops["rows"].shape[0], ops["t_bins"],
                                     ops["rt"].device)
    spectra = functools.partial(scan_kernels.mega_stages, 1, ws, **ops)
    render = functools.partial(scan_kernels.mega_stages, 2, ws, **ops)
    spectra_ms = median_ms(spectra, TIMING_REPS)
    render_ms = median_ms(render, TIMING_REPS)
    spectra_dev = device_ms(spectra, ("mega_spectra_kernel",))["total"]
    render_dev = device_ms(render, ("mega_render_kernel",))["total"]
    torch.cuda.synchronize()
    lims = spectra_bound(ops)
    name = "mega_edge_ttc" if label == "plain" else f"mega_edge_ttc+{label}"
    blocks = scan_kernels.resident_blocks(n_opp, "pool_rot" in label)
    kernels = {"spectra": {"function": MEGA_SPECTRA, **resources(reports, name, MEGA_SPECTRA),
                           "blocks_per_sm": blocks["spectra"], "ms": spectra_ms,
                           "device_ms": spectra_dev, **lims},
               "render": {"function": KERNEL_FUNCTIONS[name][1], **resources(reports, name),
                          "blocks_per_sm": blocks["render"], "ms": render_ms,
                          "device_ms": render_dev}}
    say("kernel", f"{label}: spectra kernel bound {lims['bound_ms']:.4f} ms by "
        f"{lims['bound_by']} (float64 at {F64_FLOPS / 1e12:.1f} TFLOP/s on the tensor cores)")
    for role, k in kernels.items():
        say("kernel", f"{label}: {role} kernel alone {k['ms']:.3f} ms, on the device "
            f"{k['device_ms']:.4f} ms; {k['function']}: "
            f"{k['regs']} registers, {k['spill_bytes']} spill bytes, "
            f"{k['blocks_per_sm']} resident block(s) a SM")
    return {"spectra_ms": spectra_ms, "render_ms": render_ms, "kernels": kernels}


def mega_phase(cfg, params, dev, reports) -> dict:
    """The megakernel's plain, opp and opp+pool_rot variants against the
    twin, the pair and each of its kernels timed; {variant: record
    fields}."""
    import torch

    from red_gym_tpu_torch.ops import agent_scan, collision, scan_fast, scan_kernels

    cell = float(params.rtex.cell)
    mega, ref = scan_kernels.mega_edge_ttc, scan_kernels.mega_edge_ttc_reference
    gen = torch.Generator(device=dev).manual_seed(0)
    poses = random_free_poses(params, ENVS * AGENTS, gen).reshape(ENVS, AGENTS, 3)
    vel = -2.0 + 10.0 * torch.rand((ENVS, AGENTS), generator=gen, device=dev)
    rows = torch.randint(0, cfg.noise_pool_rows, (ENVS,), generator=gen, device=dev)
    ops = scan_fast.mega_operands(poses, params.tables, params.tmap, params.rtex,
                                  cfg, params.noise_pool[rows], vel)
    if ops["ew_dtype"] != torch.bfloat16:
        fail(f"e/w taps resolved to {ops['ew_dtype']}, expected bfloat16 on CUDA")
    out_k, hit_k = mega(**ops)
    out_r, hit_r = ref(**ops)
    torch.cuda.synchronize()
    rec = {"plain": {"max_abs_err": scan_bar("plain", out_k, hit_k, out_r, hit_r, cell),
                     **timed("plain", lambda: mega(**ops), lambda: ref(**ops),
                             mega_bound(ops, out_k, hit_k), {}, MEGA_DEVICE),
                     **mega_stage_times("plain", ops, reports, 0)}}

    poses = close_poses(params, ENVS, AGENTS, gen)
    verts = collision.get_vertices(poses, params.vehicle.length, params.vehicle.width)
    opp = agent_scan.opponent_slab_scalars(poses, verts, params.tables)
    pool_off = torch.tensor([cfg.noise_pool_rows - 37], dtype=torch.int32, device=dev)
    for name, noise, off in (("opp", params.noise_pool[rows], None),
                             ("opp+pool_rot", params.noise_pool, pool_off)):
        ops = scan_fast.mega_operands(poses, params.tables, params.tmap, params.rtex,
                                      cfg, noise, vel, opp=opp, pool_off=off)
        out_k, hit_k = mega(**ops)
        out_r, hit_r = ref(**ops)
        base, _ = ref(**{**ops, "opp": None, "sines": None})
        torch.cuda.synchronize()
        err = scan_bar(name, out_k, hit_k, out_r, hit_r, cell)
        shortened = int((out_k < base - 1e-6).sum())
        say("kernel", f"{name}: {shortened} beams shortened by an opponent")
        if shortened == 0:
            fail(f"{name}: no beam shortened by an opponent")
        rec[name] = {"max_abs_err": err,
                     **timed(name, lambda: mega(**ops), lambda: ref(**ops),
                             mega_bound(ops, out_k, hit_k), {}, MEGA_DEVICE),
                     **mega_stage_times(name, ops, reports, opp.shape[-1] // 10)}
    return rec


def blend_phase(cfg, params, dev, reports) -> dict:
    """The four epilogue kernels against their twins on operands of the
    bilinear config's prep chain, cars within 2.5 m of each other;
    {kernel name: record fields}."""
    import torch

    from red_gym_tpu_torch.ops import blend_kernels

    cell = float(params.rtex.cell)
    gen = torch.Generator(device=dev).manual_seed(5)
    poses = close_poses(params, ENVS, AGENTS, gen)
    ops = blend_operands(cfg, params, poses, gen)
    if ops["theta_shuffle_blend_edge"]["ew_dtype"] != torch.bfloat16:
        fail("e/w taps did not resolve to bfloat16 on CUDA")
    rec = {}
    for name, kw in ops.items():
        kernel = getattr(blend_kernels, name)
        twin = getattr(blend_kernels, name + "_reference")
        got, want = kernel(**kw), twin(**kw)
        torch.cuda.synchronize()
        out_k, hit_k = got if isinstance(got, tuple) else (got, None)
        out_r, hit_r = want if isinstance(want, tuple) else (want, None)
        err = scan_bar(name, out_k, hit_k, out_r, hit_r, cell)
        if name.endswith("_opp"):
            base, _ = blend_kernels.theta_shuffle_blend_edge_ttc_reference(
                **ops["theta_shuffle_blend_edge_ttc"])
            shortened = int((out_k < base - 1e-6).sum())
            say("kernel", f"{name}: {shortened} beams shortened by an opponent")
            if shortened == 0:
                fail(f"{name}: no beam shortened by an opponent")
        # kernel 7's arithmetic is one product, spec_r @ gmat (all three
        # taps), then an elementwise blend; the edge forms have seven
        # products and a ramp render, no one call
        library = (lambda: kw["spec_r"] @ kw["gmat"]) if name == "theta_shuffle_blend" \
            else None
        rec[name] = {"max_abs_err": err,
                     **timed(name, lambda: kernel(**kw), lambda: twin(**kw),
                             blend_bound(kw, out_k, hit_k), resources(reports, name),
                             (KERNEL_FUNCTIONS[name][1].split("<")[0],), library)}
        if library is not None:
            under_load(name, lambda: kernel(**kw), library, rec[name])
    return rec


def blend_bound(kw, out, hit) -> dict:
    """An epilogue kernel's bound: seven (T x B) tap products per row for
    the edge forms, three for kernel 7; bytes of every operand it reads
    and of the scan (and hits) it writes."""
    k_n, t_bins = kw["spec_r"].shape
    b_n = kw["c_frac"].shape[0]
    specs = [kw[s] for s in ("spec_r", "spec_e", "spec_w") if s in kw]
    moved = nbytes(*specs, *(kw.get(n) for n in (
        "f_s", "wsum", "vel", "gmat", "c_frac", "noise", "cosines", "sines",
        "side_dist", "opp")), out, hit)
    if len(specs) == 3:
        return bound(moved, **tap_work(k_n, t_bins, b_n, kw["ew_dtype"]))
    return bound(moved, f32=2.0 * k_n * 3 * t_bins * b_n)


def spectral_operands(cfg, params, poses, gen) -> dict:
    """Keyword operands of ``spectral_kernels.theta_spectral_ttc`` for
    poses (E, A, 3): the spectra of the spectral config's own prep chain
    (``scan_fast.rolled_spectra`` with the real-valued roll), speeds in
    [-2, 8) m/s and one noise pool row per env."""
    import torch

    from red_gym_tpu_torch.ops import scan_fast

    e_n, a_n = poses.shape[:2]
    dev = poses.device
    sp = scan_fast.rolled_spectra(poses, params.tmap, params.rtex, cfg)
    vel = -2.0 + 10.0 * torch.rand((e_n * a_n,), generator=gen, device=dev)
    rows = torch.randint(0, cfg.noise_pool_rows, (e_n,), generator=gen, device=dev)
    return dict(spec_r=sp.spec_r.reshape(-1, cfg.rt_theta_bins),
                wsum=sp.wsum.reshape(-1), vel=vel, smat=params.rtex.smat,
                noise=params.noise_pool[rows], cosines=params.tables.beam_cosines,
                side_dist=params.tables.side_distances, max_range=cfg.max_range,
                ttc_thresh=cfg.ttc_thresh, agents_per_env=a_n)


def spectral_phase(cfg, params, dev, reports) -> dict:
    """Kernel 5 against its twin and torch.matmul(spec_r, smat) on operands
    of the ultra config's prep chain, cars within 2.5 m of each other."""
    import torch

    from red_gym_tpu_torch.ops import spectral_kernels

    gen = torch.Generator(device=dev).manual_seed(8)
    kw = spectral_operands(cfg, params, close_poses(params, ENVS, AGENTS, gen), gen)
    kernel = spectral_kernels.theta_spectral_ttc
    twin = spectral_kernels.theta_spectral_ttc_reference
    out_k, hit_k = kernel(**kw)
    out_r, hit_r = twin(**kw)
    torch.cuda.synchronize()
    err = scan_bar("theta_spectral_ttc", out_k, hit_k, out_r, hit_r, float(params.rtex.cell))
    k_n, t_bins = kw["spec_r"].shape
    b_n = kw["smat"].shape[1]
    lims = bound(nbytes(*(kw[n] for n in ("spec_r", "wsum", "vel", "smat", "noise",
                                          "cosines", "side_dist")), out_k, hit_k),
                 f32=2.0 * k_n * t_bins * b_n)
    def library():
        return torch.matmul(kw["spec_r"], kw["smat"])

    rec = {"max_abs_err": err,
           **timed("theta_spectral_ttc", lambda: kernel(**kw), lambda: twin(**kw), lims,
                   resources(reports, "theta_spectral_ttc"), ("theta_spectral_kernel",),
                   library)}
    under_load("theta_spectral_ttc", lambda: kernel(**kw), library, rec)
    return rec


def under_load(label: str, kernel, library, rec: dict) -> None:
    """The card's SM clock and power while the kernel, then its library
    call, run back to back: the float32 peak assumes the maximum clock."""
    for who, fn, ms in (("kernel", kernel, rec["ms"]), ("library call", library,
                                                         rec["library_ms"])):
        say("kernel", f"{label}: {who} under load: nvidia-smi clocks.sm, clocks.max.sm, "
            f"power.draw: {clock_under_load(fn, ms)}")


def prestep_phase(cfg, params, dev, reports) -> dict:
    """The state kernel against its eager twin on random in-range states:
    all five outputs bit-equal.  Beside the event-window time, its device
    time, the device time of an empty kernel of its grid and block
    (``floor_ms``) and its wrapper's host time a call (``host_us``)."""
    import torch

    from red_gym_tpu_torch.ops import state_kernels

    gen = torch.Generator(device=dev).manual_seed(2)
    args = random_states(params, (ENVS, AGENTS), gen)
    pack = state_kernels.pack_params(params.vehicle, params.tmap, params.rtex)
    got = state_kernels.prestep(cfg, params, *args, pack)
    want = state_kernels.prestep_reference(cfg, params, *args)
    torch.cuda.synchronize()
    names = ("x", "steer_buf", "steer_cnt", "rows", "scal")
    exact = {n: bool(torch.equal(g, w)) for n, g, w in zip(names, got, want)}
    max_err = max(float((g.float() - w.float()).abs().max())
                  for n, g, w in zip(names, got, want))
    ints = dict(rows=(got[3], want[3]), steer_cnt=(got[2], want[2]),
                i_f=(got[4][..., 3], want[4][..., 3]), inb=(got[4][..., 4], want[4][..., 4]))
    n_diff = {n: int((g != w).sum()) for n, (g, w) in ints.items()}
    kin = float((args[0][..., 3].abs() < 0.5).float().mean())
    say("kernel", f"prestep: K={ENVS * AGENTS} ({100 * kin:.1f}% of rows in the kinematic "
        f"branch): max |diff| {max_err:.3e}; bit-exact {exact}; integer mismatches {n_diff}")
    if any(n_diff.values()):
        fail(f"prestep: integer outputs differ from the twin: {n_diff}")
    if not all(exact.values()):
        fail(f"prestep: outputs not bit-equal to the twin: {exact}, max |diff| {max_err}")
    k_n = ENVS * AGENTS
    lims = bound(nbytes(*args, pack, *got), f32=float(PRESTEP_OPS_PER_ROW * k_n))

    def kernel():
        state_kernels.prestep(cfg, params, *args, pack)

    rec = timed("prestep", kernel,
                lambda: state_kernels.prestep_reference(cfg, params, *args), lims,
                resources(reports, "prestep"), ("prestep_kernel",))
    floor_ms = device_ms(lambda: state_kernels.launch_floor(k_n, dev),
                         ("prestep_floor_kernel",))["total"]
    wrapper_us = host_us(kernel)
    say("kernel", f"prestep: floor (an empty kernel of its grid and block, profiler) "
        f"{floor_ms:.4f} ms; wrapper host time {wrapper_us:.1f} us a call "
        f"(median of {HOST_CALLS // 20} batches of 20 calls behind torch.cuda._sleep)")
    return {"max_abs_err": max_err, **rec, "floor_ms": floor_ms, "host_us": wrapper_us}


def march_iterations(poses, tables, tmap, cfg, midx=None):
    """Iterations of every ray of the march's beams form at poses (..., 3)
    (on each pose's map of a stack with ``midx`` (...)), counted by an
    eager replay of the twin's march body (``march_kernels._march_body``),
    the rays still running compacted every iteration -> (iterations (...)
    int32 flat, ranges (..., B))."""
    import torch

    from red_gym_tpu_torch.ops import march_kernels as mk

    idx = mk.beam_theta_indices(poses[..., 2], cfg)
    shape = idx.shape
    x = torch.broadcast_to(poses[..., 0:1], shape).reshape(-1)
    y = torch.broadcast_to(poses[..., 1:2], shape).reshape(-1)
    c, s = tables.cosines[idx].reshape(-1), tables.sines[idx].reshape(-1)
    if midx is not None:
        midx = torch.broadcast_to(midx[..., None], shape).reshape(-1)
    d = mk.dt_lookup(x, y, tmap, midx)
    total = d.clone()
    out = total.clone()
    n_it = torch.zeros(x.numel(), dtype=torch.int32, device=x.device)
    live = torch.arange(x.numel(), device=x.device)
    while True:
        act = (d > cfg.eps) & (total <= cfg.max_range)
        keep = torch.nonzero(act).squeeze(1)
        out[live] = total
        if keep.numel() == 0:
            break
        live = live[keep]
        x, y, c, s, d, total = (v[keep] for v in (x, y, c, s, d, total))
        if midx is not None:
            midx = midx[keep]
        n_it[live] += 1
        x, y, d, total = mk._march_body(x, y, c, s, d, total, tmap, cfg.eps, cfg.max_range,
                                        midx)
    return n_it, torch.clamp(out, max=cfg.max_range).reshape(shape)


def iteration_stats(n_it) -> dict:
    """Iterations a ray: mean, p99, max; the mean over warps (32
    neighbouring rays, which a warp of the kernel holds and runs as long as
    its longest) and over blocks (256 neighbouring rays, whose slot on an
    SM a block keeps until its longest ends) of that longest; and the lane
    utilisation of the warps, the iterations over 32 lanes times the warps'
    longest."""
    import torch

    def longest(k: int):
        return torch.nn.functional.pad(n_it, (0, -n_it.numel() % k)).reshape(-1, k).amax(1)

    rays = n_it.numel()
    srt = n_it.sort().values
    warp_max = longest(32)
    iters = float(n_it.sum(dtype=torch.int64))
    return {"mean": float(n_it.float().mean()), "p99": int(srt[int(0.99 * (rays - 1))]),
            "max": int(srt[-1]), "warp_max_mean": float(warp_max.float().mean()),
            "block_max_mean": float(longest(256).float().mean()),
            "lane_utilisation": iters / (32 * float(warp_max.sum(dtype=torch.int64)))}


def say_iterations(label: str, its: dict) -> None:
    """One line: the iterations a ray, a warp's and a block's longest, and
    the lane utilisation of the kernel (one thread a ray), counted on the
    replay: predicted and achieved are one number, since a warp of the
    kernel runs exactly as long as its longest ray."""
    say("kernel", f"{label}: iterations a ray mean {its['mean']:.2f}, p99 {its['p99']}, max "
        f"{its['max']}; longest of a warp's 32 mean {its['warp_max_mean']:.2f}, of a "
        f"block's 256 mean {its['block_max_mean']:.2f}; lane utilisation, predicted and "
        f"achieved (replay, one thread a ray): {its['lane_utilisation']:.3f}")


def march_bound(out, tmap, tables, poses, iterations: int, rays: int,
                midx=None) -> dict:
    """The float32 march's bound: its operations (MARCH_OPS_PER_ITER a
    counted iteration and the first lookup of each ray, THETA_INDEX_OPS a
    ray), each one lane instruction at LANE_OPS_PER_S, against its bytes
    (the (K, B) output written once, the distance transform or the stack of
    them, poses, map indices and theta tables read once) over the memory
    rate."""
    ops = MARCH_OPS_PER_ITER * (iterations + rays) + THETA_INDEX_OPS * rays
    return bound(nbytes(out, tmap.dt, poses, midx, tables.cosines, tables.sines),
                 lane=float(ops))


def march_phase(cfg, params, dev, reports) -> dict:
    """The march kernel's beams form against its twin at full width:
    ENVS x AGENTS cars at random free poses on the map, BEAMS beams,
    float32, every range ``torch.equal``; the same in float64 on
    MARCH_F64_ENVS envs and with march_iters=40; iterations per ray from
    the eager replay; times and bound."""
    import torch

    from red_gym_tpu_torch import assets
    from red_gym_tpu_torch.maps.loader import load_map
    from red_gym_tpu_torch.ops import march_kernels as mk, scan

    tmap, tables = params.tmap, params.tables
    gen = torch.Generator(device=dev).manual_seed(9)
    poses = map_free_poses(tmap, ENVS * AGENTS, gen).reshape(ENVS, AGENTS, 3)

    def kernel():
        return mk.march_beams(poses, tables.cosines, tables.sines, tmap, cfg)

    def twin():
        return mk.march_beams_reference(poses, tables.cosines, tables.sines, tmap, cfg)

    out_k, out_r = kernel(), twin()
    n_it, out_e = march_iterations(poses, tables, tmap, cfg)
    torch.cuda.synchronize()
    rays = n_it.numel()
    its = iteration_stats(n_it)
    checks = {"float32": torch.equal(out_k, out_r), "replay": torch.equal(out_k, out_e)}
    say("kernel", f"march: {ENVS} x {AGENTS} cars x {cfg.num_beams} beams = {rays} rays, "
        f"float32: kernel torch.equal to its twin {checks['float32']} and to the counted "
        f"replay {checks['replay']}; ranges in [{float(out_k.min()):.3f}, "
        f"{float(out_k.max()):.3f}] m")
    say_iterations("march", its)

    it_cfg = dataclasses.replace(cfg, march_iters=40)
    got = mk.march_beams(poses, tables.cosines, tables.sines, tmap, it_cfg)
    checks["march_iters=40"] = torch.equal(
        got, mk.march_beams_reference(poses, tables.cosines, tables.sines, tmap, it_cfg))
    c64 = dataclasses.replace(cfg, dtype="float64")
    t64 = load_map(assets.named_map_yaml(TRACK), dtype=torch.float64, device=dev)
    tab64 = scan.build_tables(c64, 0.31, 0.58, device=dev)
    p64 = map_free_poses(t64, MARCH_F64_ENVS * AGENTS, gen).reshape(MARCH_F64_ENVS, AGENTS, 3)
    got = mk.march_beams(p64, tab64.cosines, tab64.sines, t64, c64)
    checks["float64"] = torch.equal(
        got, mk.march_beams_reference(p64, tab64.cosines, tab64.sines, t64, c64))
    torch.cuda.synchronize()
    say("kernel", f"march: torch.equal to the twin with march_iters=40 "
        f"{checks['march_iters=40']}; float64 at {MARCH_F64_ENVS} x {AGENTS} cars "
        f"{checks['float64']}")
    if not all(checks.values()):
        fail(f"march: kernel not bit-equal to its twin: {checks}")
    if float(out_k.mean()) < 0.5:
        fail("march: mean range under 0.5 m: degenerate poses")

    lims = march_bound(out_k, tmap, tables, poses, int(n_it.sum(dtype=torch.int64)), rays)
    say("kernel", f"march: bound from {int(n_it.sum(dtype=torch.int64))} counted "
        f"iterations x {MARCH_OPS_PER_ITER} operations and {rays} rays x "
        f"({MARCH_OPS_PER_ITER} + {THETA_INDEX_OPS}), a lane instruction each at "
        f"{LANE_OPS_PER_S / 1e12:.1f}e12/s, "
        f"against {nbytes(out_k, tmap.dt, poses, tables.cosines, tables.sines) / 1e6:.1f} MB")
    rec = timed("march", kernel, twin, lims, resources(reports, "march"),
                ("march_beams_kernel",))
    return {"max_abs_err": float((out_k - out_r).abs().max()), **rec,
            "iterations": its}


def texture_phase(cfg, tmap) -> None:
    """The library-default texture of ``cfg`` (stored in float32 here)
    built twice with the disk cache off: its rays marched by the kernel,
    then by the twin; rt and valid must be torch.equal."""
    import torch

    from red_gym_tpu_torch.ops import march_kernels as mk, scan_fast

    cfg = dataclasses.replace(cfg, rt_dtype="float32")
    seconds, tex, launches = {}, {}, {}
    kernel = mk.march
    for who, fn in (("kernel", kernel), ("twin", mk.march_reference)):
        mk.reset_launches()
        mk.march = fn   # what scan.march calls for every ray batch of the build
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tex[who] = scan_fast.build_range_texture(tmap, cfg)
            torch.cuda.synchronize()
            seconds[who] = time.perf_counter() - t0
        finally:
            mk.march = kernel
        launches[who] = kernel.launches
    if launches["kernel"] == 0 or launches["twin"] != 0:
        fail(f"texture: march kernel launches in the two builds: {launches}")
    same = {f: torch.equal(getattr(tex["kernel"], f), getattr(tex["twin"], f))
            for f in ("rt", "valid")}
    say("texture", f"{TRACK} stride {cfg.rt_pose_stride}, float32 rt: built with the march "
        f"kernel in {seconds['kernel']:.2f} s ({launches['kernel']} launches), with its twin in "
        f"{seconds['twin']:.2f} s; torch.equal {same}")
    if not all(same.values()):
        fail(f"texture: the kernel-marched texture differs from the twin-marched one: {same}")


def map_of_stack(tmap, m: int, unpad: bool = False):
    """Map m of a stack of maps (env.make_multimap_params) as one map: its
    padded rows and columns, or with ``unpad`` its true extents only, which
    is the raw map (the padding is zeros appended after the EDT)."""
    from red_gym_tpu_torch.maps.loader import TrackMap

    one = TrackMap(*(f[m] for f in tmap))
    if unpad:
        h, w = int(one.height), int(one.width)
        one = one._replace(dt=one.dt[:h, :w].contiguous(),
                           occupancy=one.occupancy[:h, :w].contiguous())
    return one


def params_of_stack(params, m: int):
    """Map m of map-stacked params as one map's params, padded: its map
    and its texture of the stack (rows, validity, grid and cell), for
    drawing poses on it."""
    rtex = params.rtex._replace(**{f: getattr(params.rtex, f)[m]
                                   for f in ("rt", "valid", "hc", "wc", "cell")})
    return params._replace(tmap=map_of_stack(params.tmap, m), rtex=rtex)


def per_map_poses(draw, midx, a_n: int):
    """(E, a_n, 3) poses, those of the envs on map m drawn by ``draw(m,
    n_envs)`` -> (n_envs, a_n, 3)."""
    import torch

    out = None
    for m in range(int(midx.max()) + 1):
        sel = torch.nonzero(midx == m).squeeze(1)
        p = draw(m, sel.numel())
        if out is None:
            out = p.new_zeros((midx.numel(), a_n, 3))
        out[sel] = p
    return out


def to_float64(tmap):
    from red_gym_tpu_torch.maps.loader import TrackMap

    return TrackMap(*(f.double() if f.is_floating_point() else f for f in tmap))


def multimap_march_phase(cfg, params, midx, dev, reports) -> dict:
    """The march kernel's stacked form against its twin at full width:
    ENVS x AGENTS cars on random free poses of each env's map of the stack,
    BEAMS beams, float32, every range ``torch.equal``; the same with
    march_iters=40, and in float64 on MARCH_F64_ENVS envs; the envs of each
    map ``torch.equal`` to the same poses marched on that map alone (the
    raw map); iterations a ray from the eager replay; times and bound."""
    import torch

    from red_gym_tpu_torch.ops import march_kernels as mk, scan

    tmap, tables = params.tmap, params.tables
    m_n = tmap.dt.shape[0]
    raws = [map_of_stack(tmap, m, unpad=True) for m in range(m_n)]
    gen = torch.Generator(device=dev).manual_seed(11)
    poses = per_map_poses(lambda m, n: map_free_poses(raws[m], n * AGENTS, gen).reshape(
        n, AGENTS, 3), midx, AGENTS)
    row_maps = midx[:, None].expand(ENVS, AGENTS).contiguous()

    def kernel():
        return mk.march_beams(poses, tables.cosines, tables.sines, tmap, cfg, row_maps)

    def twin():
        return mk.march_beams_reference(poses, tables.cosines, tables.sines, tmap, cfg,
                                        row_maps)

    out_k, out_r = kernel(), twin()
    n_it, out_e = march_iterations(poses, tables, tmap, cfg, row_maps)
    torch.cuda.synchronize()
    its = iteration_stats(n_it)
    checks = {"float32": torch.equal(out_k, out_r), "replay": torch.equal(out_k, out_e)}
    it_cfg = dataclasses.replace(cfg, march_iters=40)
    checks["march_iters=40"] = torch.equal(
        mk.march_beams(poses, tables.cosines, tables.sines, tmap, it_cfg, row_maps),
        mk.march_beams_reference(poses, tables.cosines, tables.sines, tmap, it_cfg,
                                 row_maps))
    c64 = dataclasses.replace(cfg, dtype="float64")
    t64 = to_float64(tmap)
    tab64 = scan.build_tables(c64, 0.31, 0.58, device=dev)
    m64 = row_maps[:MARCH_F64_ENVS]
    p64 = poses[:MARCH_F64_ENVS].double()
    checks["float64"] = torch.equal(
        mk.march_beams(p64, tab64.cosines, tab64.sines, t64, c64, m64),
        mk.march_beams_reference(p64, tab64.cosines, tab64.sines, t64, c64, m64))
    alone = {}
    for m in range(m_n):
        sel = torch.nonzero(midx == m).squeeze(1)
        alone[m] = torch.equal(out_k[sel], mk.march_beams(
            poses[sel], tables.cosines, tables.sines, raws[m], cfg))
    torch.cuda.synchronize()
    checks["stacked == standalone, every map"] = all(alone.values())
    say("kernel", f"march (stacked, {m_n} maps, env e on map e % {m_n}): {ENVS} x "
        f"{AGENTS} cars x {cfg.num_beams} beams = {n_it.numel()} rays; ranges in "
        f"[{float(out_k.min()):.3f}, {float(out_k.max()):.3f}] m; torch.equal: {checks}; "
        f"by map {alone}")
    say_iterations("march (stacked)", its)
    if not all(checks.values()):
        fail(f"march (stacked): kernel not bit-equal: {checks}, by map {alone}")
    if float(out_k.mean()) < 0.5:
        fail("march (stacked): mean range under 0.5 m: degenerate poses")
    iters = int(n_it.sum(dtype=torch.int64))
    lims = march_bound(out_k, tmap, tables, poses, iters, n_it.numel(), row_maps)
    say("kernel", f"march (stacked): bound from {iters} counted iterations, against "
        f"{nbytes(out_k, tmap.dt, poses, row_maps, tables.cosines, tables.sines) / 1e6:.1f}"
        f" MB")
    rec = timed("march (stacked)", kernel, twin, lims, resources(reports, "march+stacked"),
                ("march_beams_stacked_kernel",))
    return {"max_abs_err": float((out_k - out_r).abs().max()), **rec, "iterations": its}


def multimap_mega_phase(cfg, params, yamls, midx, dev) -> None:
    """The megakernel with opponents on the stacked texture against its
    twin (the scan bar, hits equal), on close poses in free cells of each
    env's map; and for every map, its envs' rows ``torch.equal`` to the
    same operands run on that map alone (its own params: the raw map and
    the texture built on it)."""
    import torch

    from red_gym_tpu_torch import env
    from red_gym_tpu_torch.ops import agent_scan, collision, scan_fast, scan_kernels

    mega, ref = scan_kernels.mega_edge_ttc, scan_kernels.mega_edge_ttc_reference
    m_n = params.tmap.dt.shape[0]
    gen = torch.Generator(device=dev).manual_seed(12)
    poses = per_map_poses(lambda m, n: close_poses(params_of_stack(params, m), n, AGENTS,
                                                   gen), midx, AGENTS)
    vel = -2.0 + 10.0 * torch.rand((ENVS, AGENTS), generator=gen, device=dev)
    rows = torch.randint(0, cfg.noise_pool_rows, (ENVS,), generator=gen, device=dev)
    noise = params.noise_pool[rows]
    verts = collision.get_vertices(poses, params.vehicle.length, params.vehicle.width)
    opp = agent_scan.opponent_slab_scalars(poses, verts, params.tables)
    ops = scan_fast.mega_operands(poses, params.tables, params.tmap, params.rtex, cfg, noise,
                                  vel, opp=opp, midx=midx[:, None])
    out_k, hit_k = mega(**ops)
    out_r, hit_r = ref(**ops)
    torch.cuda.synchronize()
    cell = float(params.rtex.cell.min())
    scan_bar("opp (stacked texture)", out_k, hit_k, out_r, hit_r, cell)
    out_k, hit_k = out_k.reshape(ENVS, AGENTS, -1), hit_k.reshape(ENVS, AGENTS)
    alone = {}
    for m in range(m_n):
        sel = torch.nonzero(midx == m).squeeze(1)
        one = env.make_params(cfg, yamls[m], tmap=map_of_stack(params.tmap, m, unpad=True),
                              device=dev)
        o, h = mega(**scan_fast.mega_operands(poses[sel], one.tables, one.tmap, one.rtex, cfg,
                                              noise[sel], vel[sel], opp=opp[sel]))
        alone[m] = (torch.equal(o.reshape(-1, AGENTS, o.shape[-1]), out_k[sel])
                    and torch.equal(h.reshape(-1, AGENTS), hit_k[sel]))
        del one
    say("kernel", f"opp (stacked texture, {tuple(ops['rt'].shape)} {ops['rt'].dtype}): "
        f"each map's envs torch.equal to the map alone: {alone}")
    if not all(alone.values()):
        fail(f"megakernel: the stacked run differs from the maps alone: {alone}")


def launch_counts() -> dict:
    from red_gym_tpu_torch.ops import (blend_kernels, edt_kernels, march_kernels,
                                       raster_kernels, scan_kernels, spectral_kernels,
                                       state_kernels)

    return {**{f"mega_edge_ttc[{k}]": v
               for k, v in scan_kernels.mega_edge_ttc.launches.items()},
            "prestep": state_kernels.prestep.launches,
            **{fn.__name__: fn.launches for fn in blend_kernels.KERNELS},
            "theta_spectral_ttc": spectral_kernels.theta_spectral_ttc.launches,
            "march[rays]": march_kernels.march.launches,
            "march[beams]": march_kernels.march_beams.launches,
            "fill_polygon": raster_kernels.fill_polygon.launches,
            "draw_segments": raster_kernels.draw_segments.launches,
            "edt": edt_kernels.edt_transform.launches}


def reset_launch_counts() -> None:
    from red_gym_tpu_torch.ops import (blend_kernels, edt_kernels, march_kernels,
                                       raster_kernels, scan_kernels, spectral_kernels,
                                       state_kernels)

    edt_kernels.reset_launches()
    raster_kernels.reset_launches()
    march_kernels.reset_launches()
    scan_kernels.reset_launches()
    state_kernels.prestep.launches = 0
    blend_kernels.reset_launches()
    spectral_kernels.theta_spectral_ttc.launches = 0


def check_counts(label: str, counts: dict, uses: tuple, want: int) -> None:
    """Fail unless each kernel in ``uses`` launched ``want`` times (steps +
    reset steps) and every other kernel never."""
    for name, n in counts.items():
        if name in uses and n != want:
            fail(f"{label}: {name} launched {n} times, expected {want} (steps + resets)")
        if name not in uses and n:
            fail(f"{label}: {name} launched {n} times on a path that does not run it")


def main_path(label: str, cfg, params, dev, steps: int, uses: tuple,
              profile: bool, max_step_ms: float | None = None, maps=None,
              start=None, out: dict | None = None) -> dict:
    """Drive one path; ``uses`` names the launch counters it must advance
    (once per step and reset step); every other counter must stay 0.  With
    ``max_step_ms``, a path whose warm-up steps took longer than that a step
    times proportionally fewer steps, at least 20.  ``maps`` = (map_idx
    (E,), start table (M, A, 3)) runs map-stacked params: env e starts at
    its map's row of the table, and each auto-reset draws a map and its
    start (make_rollout's randomize_starts).  ``start`` (A, 3) replaces
    track_0019's waypoint starts; ``out`` receives the final carry and the
    env-steps/s."""
    import torch

    from red_gym_tpu_torch import assets, rollout

    roll_kw = {}
    if maps is None:
        if start is None:
            start = assets.waypoint_start_poses(TRACK, AGENTS)
        start = torch.as_tensor(start, dtype=cfg.tdtype, device=dev)
        poses = start.expand(ENVS, AGENTS, 3).contiguous()
        reset_kw = {}
    else:
        midx, table = maps
        poses = table[midx.long()]
        reset_kw, roll_kw = {"map_idx": midx}, {"randomize_starts": table}
    gen = torch.Generator(device=dev).manual_seed(1)
    policy = rollout.random_policy(cfg)
    state, obs, *_ = rollout.batched_reset(cfg, params, poses, gen, **reset_kw)
    carry = rollout.RolloutCarry(state, obs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, _ = rollout.make_rollout(cfg, params, policy, WARMUP_STEPS, **roll_kw)(carry, gen)
    torch.cuda.synchronize()
    warm_ms = 1e3 * (time.perf_counter() - t0) / WARMUP_STEPS
    if max_step_ms is not None and warm_ms > max_step_ms:
        steps = max(20, min(steps, int(steps * max_step_ms / warm_ms)))
        say(f"main:{label}", f"a warm-up step took {warm_ms:.1f} ms, above "
            f"{max_step_ms:.0f} ms: timing {steps} steps")
    if profile:
        profile_steps(label, cfg, params, policy, carry, gen,
                      table=label in ("default", "bilinear", "ultra", "exact", "multimap",
                                      "multimap_exact"), roll_kw=roll_kw)
    run = rollout.make_rollout(cfg, params, policy, steps, **roll_kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    carry, outs = run(carry, gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    resets = outs["resets"]
    n_done = int(outs["done"].sum())
    say(f"main:{label}", f"{steps} steps of {ENVS} envs x {AGENTS} agents x "
        f"{cfg.num_beams} beams in {seconds:.3f} s: "
        f"{ENVS * steps / seconds:.0f} env-steps/s "
        f"({1e3 * seconds / steps:.3f} ms/step incl. auto-reset), "
        f"peak device memory {peak / 2**30:.2f} GiB")
    say(f"main:{label}", f"{n_done} env episodes ended; {resets} of {steps} steps "
        f"reset some env; launches {counts}")
    check_counts(label, counts, uses, steps + resets)
    scans = carry.obs.scans
    if not torch.isfinite(scans).all():
        fail(f"{label}: non-finite scans")
    lo, hi = float(scans.min()), float(scans.max())
    if lo < -NOISE_MARGIN or hi > cfg.max_range + NOISE_MARGIN:
        fail(f"{label}: scans outside [-{NOISE_MARGIN}, max_range + {NOISE_MARGIN}]: "
             f"[{lo}, {hi}]")
    far_beams = float((scans > 0.5).float().mean())
    say(f"main:{label}", f"scans in [{lo:.3f}, {hi:.3f}] m, mean "
        f"{float(scans.mean()):.3f} m, {100 * far_beams:.1f}% of beams beyond 0.5 m")
    if far_beams < 0.5:
        fail(f"{label}: most beams read under 0.5 m: degenerate scans")
    if out is not None:
        out["carry"] = carry
        out["env_steps_per_s"] = ENVS * steps / seconds
    if maps is not None:
        used = torch.bincount(carry.state.map_idx.long(), minlength=maps[1].shape[0])
        say(f"main:{label}", f"envs on each map after the run: {used.tolist()}")
        if int((used > 0).sum()) < maps[1].shape[0]:
            fail(f"{label}: some map has no env left")
    return counts


def profile_steps(label, cfg, params, policy, carry, gen, table: bool,
                  roll_kw: dict) -> None:
    """Device kernels and device busy time per step over 5 steps
    (torch.profiler), and with ``table`` the kernels by device time."""
    from red_gym_tpu_torch import rollout

    n = 5
    run = rollout.make_rollout(cfg, params, policy, n, **roll_kw)
    outs = {}
    ops, busy_ms, prof = device_busy(lambda: outs.update(run(carry, gen)[1]))
    say(f"profile:{label}", f"{n} steps ({outs['resets']} reset steps): "
        f"{ops} device ops ({ops / n:.0f} per step), "
        f"device busy {busy_ms:.2f} ms ({busy_ms / n:.2f} ms per step)")
    if table:
        for line in prof.key_averages().table(sort_by="cuda_time_total",
                                              row_limit=25).splitlines():
            print(f"[profile] {line}", flush=True)


def device_busy(fn):
    """Run ``fn`` under torch.profiler -> (device ops, device busy ms, the
    profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(dev_events), sum(e.time_range.elapsed_us() for e in dev_events) / 1e3, prof


PPO_ITERS = 3              # timed train_steps of the ppo phase, after one warm-up
EVAL_STEPS = 200           # the checkpoint phase's mean-policy rollout
PURSUIT_BYTES = 2 * 2**30  # the pursuit step's own peak memory at full width
REPRO_PPO_ITERS = 3        # iterations of each of the two seed-0 runs of a trainer
REPRO_BITMAP_ITERS = 6     # (the bitmap trainer: 2 warm-up, 4 with updates)


def same_seed_twice(label: str, trainer: str, iters: int, main, multi_map: bool = False) -> None:
    """``trainer``'s ``main`` at the seed runner's flags for it
    (``ppo_seeds.trainer_flags``, ``--iters`` ``iters``, seed 0) twice, its
    output kept out of this one's: fail unless the two CSVs agree in every
    column but the time columns (``ppo_seeds.compare``)."""
    import contextlib
    import io
    import tempfile

    import torch

    from red_gym_tpu_torch.examples import ppo_seeds

    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32)
    runner = argparse.Namespace(trainer=trainer, envs=None, iters=iters, multi_map=multi_map,
                                trainer_args="--device cuda")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        stems = [os.path.join(d, f"run{i}") for i in (0, 1)]
        for stem in stems:
            argv = ppo_seeds.trainer_flags(runner, 0, stem)[2:]
            with contextlib.redirect_stdout(io.StringIO()):
                main(argv)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32 = flags
        out = ppo_seeds.compare(*(stem + ".csv" for stem in stems))
        curves = [ppo_seeds.load(stem + ".csv") for stem in stems]
        shown = " ".join(a for a in argv if not a.startswith(d))
    secs = [[c[k] for k in ppo_seeds.TIME_COLUMNS if k in c][0] for c in curves]
    say(label, f"seed 0 twice, {out['rows']} iterations each ({shown}), "
        f"{time.perf_counter() - t0:.1f} s; the time column of each run {secs}; every other "
        f"column equal: {out['equal']} {out['first_differing_row']}")
    if not out["equal"] or out["rows"] != iters:
        fail(f"{label}: seed 0 does not reproduce its run: {out}")


def ppo_trainer(argv: list, params, dev):
    """train_ppo's trainer for its flags ``argv`` on ``params`` (built for the
    same config), with --envs ENVS: (ppo, pstate, states, obs, args,
    tracks)."""
    import torch

    from red_gym_tpu_torch import assets, rollout
    from red_gym_tpu_torch.agents.ppo import PPO, PPOConfig
    from red_gym_tpu_torch.examples import train_ppo

    args = train_ppo.parse_args(["--envs", str(ENVS)] + argv)
    cfg = train_ppo.make_config(args)
    tracks = (assets.packaged_tracks() if args.multi_map
              else [assets.named_map_yaml(TRACK)])
    table = torch.as_tensor(assets.start_pose_table(tracks, AGENTS), dtype=cfg.tdtype,
                            device=dev)
    midx = (torch.arange(ENVS, device=dev) % len(tracks)).to(torch.int32)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    states, obs, *_ = rollout.batched_reset(cfg, params, table[midx.long()], gen,
                                            map_idx=midx if args.multi_map else None)
    ppo = PPO(cfg, params, PPOConfig(rollout_len=args.rollout),
              opponent_plan=train_ppo.opponent_hook(args, tracks, dev))
    pstate = ppo.init(torch.Generator().manual_seed(args.seed + 1))
    return ppo, pstate, states, obs, args, tracks


def timed_halves(ppo, times: dict) -> None:
    """Time ppo.collect and ppo._update, each between two synchronizes, as
    train_step calls them."""
    import torch

    def wrap(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            times[name] += time.perf_counter() - t0
            return out
        return run

    ppo.collect = wrap("collect", ppo.collect)
    ppo._update = wrap("update", ppo._update)


def ppo_phase(params, dev, profile: bool):
    """The trainer's default config: a warm-up train_step, then PPO_ITERS
    timed ones -> (ppo, pstate, states, obs, kernel 4's launches)."""
    import torch

    from red_gym_tpu_torch.examples import train_ppo

    ppo, pstate, states, obs, args, _ = ppo_trainer([], params, dev)
    if ppo.cfg.rt_spatial != "bilinear" or ppo.cfg.scan_mode != "fast":
        fail(f"ppo: the trainer's default config is not the bilinear fast scan: {ppo.cfg}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pstate, states, obs, metrics = ppo.train_step(pstate, states, obs)
    loss0 = float(metrics["loss"])
    say("ppo", f"warm-up iteration {time.perf_counter() - t0:.2f} s, loss {loss0:.4f}")
    if profile:
        pstate, states, obs, _ = train_ppo.profile_iteration(ppo, pstate, states, obs)
    before = {k: v.clone() for k, v in pstate.policy.state_dict().items()}
    times = {"collect": 0.0, "update": 0.0}
    timed_halves(ppo, times)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    resets, lines, windows = 0, [], [pstate.noise]
    for _ in range(PPO_ITERS):
        pstate, states, obs, metrics = ppo.train_step(pstate, states, obs)
        resets += int(metrics["reset_steps"])
        lines.append({k: round(float(v), 6) for k, v in metrics.items()})
        windows.append(pstate.noise)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    del ppo.collect, ppo._update
    steps = PPO_ITERS * args.rollout
    n = ENVS * steps
    say("ppo", f"{PPO_ITERS} iterations of {ENVS} envs x {AGENTS} agents x {BEAMS} beams, "
        f"rollout {args.rollout}, 4 minibatches x 2 epochs: {seconds:.3f} s, "
        f"{n / seconds:.0f} env-steps/s a whole iteration; collect {times['collect']:.3f} s "
        f"({n / times['collect']:.0f} env-steps/s); update "
        f"{1e3 * times['update'] / PPO_ITERS:.1f} ms an iteration; peak device memory "
        f"{peak / 2**30:.2f} GiB, {(peak - base) / 2**30:.2f} GiB above what was allocated "
        f"before (this run's textures, envs and trainer)")
    say("ppo", f"metrics {lines}; {resets} of {steps} collect steps reset some env; "
        f"launches {counts}")
    check_counts("ppo", counts, ("theta_shuffle_blend_edge_ttc_opp",), steps + resets)
    if not all(math.isfinite(m["loss"]) for m in lines):
        fail(f"ppo: non-finite loss {lines}")
    from red_gym_tpu_torch.agents.ppo import DIAGNOSTICS
    diag = {k: [m[k] for m in lines] for k in DIAGNOSTICS}
    say("ppo", f"update diagnostics of the {PPO_ITERS} timed iterations: {diag}")
    if not all(math.isfinite(v) for vals in diag.values() for v in vals):
        fail(f"ppo: a non-finite update diagnostic {diag}")
    # JAX's key chain: each rollout reuses the last one's action noise
    # shifted by the epochs, and draws only its last `epochs` steps
    k = ppo.pcfg.epochs
    shifted = [torch.equal(b[:-k], a[k:]) and not torch.equal(b[-k:], a[-k:])
               for a, b in zip(windows, windows[1:])]
    say("ppo", f"action noise of each timed rollout = the last one's shifted by {k} "
        f"steps, its last {k} steps new: {shifted}")
    if not all(shifted):
        fail(f"ppo: the action noise does not follow JAX's key chain: {shifted}")
    after = pstate.policy.state_dict()
    if all(torch.equal(before[k], after[k]) for k in before):
        fail("ppo: no parameter moved in the timed iterations")
    same_seed_twice("ppo", "ppo", REPRO_PPO_ITERS, train_ppo.main, multi_map=True)
    return ppo, pstate, states, obs, counts["theta_shuffle_blend_edge_ttc_opp"]


def ppo_once(label: str, argv: list, params, dev, uses: str, after=None) -> int:
    """One train_step of train_ppo ``argv`` -> the launches of kernel
    ``uses``; ``after(ppo, states before, states after, tracks, dev)``
    checks more."""
    import torch

    ppo, pstate, states, obs, args, tracks = ppo_trainer(argv, params, dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    pstate, states2, obs2, metrics = ppo.train_step(pstate, states, obs)
    resets = int(metrics["reset_steps"])
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    say(label, f"one iteration (first, with its warm-up) {seconds:.2f} s, "
        f"{ENVS * args.rollout / seconds:.0f} env-steps/s; loss "
        f"{float(metrics['loss']):.4f}, speed {float(metrics['speed_mean']):.3f}; "
        f"{resets} reset steps; launches {counts}")
    check_counts(label, counts, (uses,), args.rollout + resets)
    if not math.isfinite(float(metrics["loss"])):
        fail(f"{label}: non-finite loss")
    if after is not None:
        after(ppo, states, states2, tracks, dev)
    return counts[uses]


def pursuit_progress(ppo, states, states2, tracks, dev) -> None:
    """The opponents of envs that did not restart advanced along their
    track's raceline; the pursuit step's own peak memory."""
    import torch

    from red_gym_tpu_torch import assets, env
    from red_gym_tpu_torch.agents import pure_pursuit as pp

    stacked = torch.stack([pp.load_waypoints_csv(assets.waypoints_csv(t),
                                                 dtype=torch.float32, device=dev)
                           for t in tracks])
    lines = stacked[states.map_idx.long(), :, :2]
    steps = ppo.pcfg.rollout_len
    kept = states2.step_idx == states.step_idx + steps
    _, d0, _, i0 = pp.nearest_point(states.x[:, 1, 0], states.x[:, 1, 1], lines)
    _, d1, _, i1 = pp.nearest_point(states2.x[:, 1, 0], states2.x[:, 1, 1], lines)
    n_wp = lines.shape[1]
    adv = torch.remainder(i1 - i0, n_wp)
    fwd = (adv > 0) & (adv < n_wp // 2) & kept
    share = float(fwd.sum()) / max(int(kept.sum()), 1)
    say("ppo_multimap_pursuit", f"{int(kept.sum())} of {ENVS} envs did not restart; "
        f"their opponents advanced along their raceline in {100 * share:.1f} % of envs "
        f"(median {float(adv[kept].float().median()):.0f} waypoints, distance to the "
        f"raceline median {float(d1[kept].median()):.3f} m)")
    if int(kept.sum()) < ENVS // 2 or share < 0.9:
        fail("ppo_multimap_pursuit: the opponents did not move forward along their raceline")
    obs = env._build_obs(states2, torch.zeros((ENVS, AGENTS, 1), device=dev))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ppo.opponent_plan(obs, states2.map_idx)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    say("ppo_multimap_pursuit", f"pursuit step of {ENVS} x {AGENTS} cars on {n_wp} "
        f"waypoints: peak {peak / 2**30:.3f} GiB above what was allocated")
    if peak > PURSUIT_BYTES:
        fail(f"ppo_multimap_pursuit: the pursuit step took {peak / 2**30:.2f} GiB")


def checkpoint_phase(ppo, pstate, states, obs) -> None:
    """Save and restore a PPOState and an EnvState on the card; then the
    mean policy's --eval rollout."""
    import tempfile

    import torch

    from red_gym_tpu_torch.examples import train_ppo
    from red_gym_tpu_torch.utils import checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        path = checkpoint.save(os.path.join(tmp, "ckpt.pt"), {"pstate": pstate,
                                                             "states": states})
        size = os.path.getsize(path)
        like = {"pstate": ppo.init(torch.Generator().manual_seed(12345)),
                "states": states}
        got = checkpoint.restore(path, like=like)
    same = (all(torch.equal(v, got["pstate"].policy.state_dict()[k])
                for k, v in pstate.policy.state_dict().items())
            and torch.equal(pstate.gen.get_state(), got["pstate"].gen.get_state())
            and all(torch.equal(a, b) for a, b in zip(states, got["states"])
                    if a is not None))
    opt_a, opt_b = pstate.optimizer.state_dict(), got["pstate"].optimizer.state_dict()
    same = same and all(torch.equal(v, opt_b["state"][i][k])
                        for i, s in opt_a["state"].items() for k, v in s.items())
    on_card = all(t.is_cuda for t in got["pstate"].policy.state_dict().values())
    say("checkpoint", f"PPOState + EnvState ({size / 1e6:.1f} MB): restored torch.equal "
        f"{same}, on the card {on_card}")
    if not (same and on_card):
        fail("checkpoint: the restored state differs from the saved one")
    t0 = time.perf_counter()
    speed, crash, laps = train_ppo.evaluate(ppo, got["pstate"], states, obs, EVAL_STEPS)
    say("checkpoint", f"eval over {ENVS} envs x {EVAL_STEPS} steps ({time.perf_counter() - t0:.1f} "
        f"s): mean speed {speed:.2f} m/s, crash rate {crash:.3f}, final laps (mean) "
        f"{laps:.2f}")
    if not all(map(math.isfinite, (speed, crash, laps))):
        fail("checkpoint: non-finite eval numbers")


PROFILE_STEPS = 5         # steps under torch.profiler with --profile
VEC_NUMPY_STEPS = 50      # steps of the [vec_env] loop with the numpy boundary
VEC_HAND_STEPS = 20       # steps of the [vec_env] wrapper against the hand loop
POISON_SHARE = 0.01       # envs poisoned with NaN in the [debug] phase
COMPAT_STEPS = 1000       # legacy-API steps of the [gym_compat] phase
# both gym_compat cars drive at the raceline's own speeds: at the reference's
# speed gain of 1.375 (tuned for its example map) a pure-pursuit car runs off
# track_0019 into the wall
COMPAT_VGAIN = 1.0


def vec_hand_loop(vec, actions) -> tuple[dict, int, dict]:
    """Step ``vec`` (a VecF110Env) with each of ``actions`` and, beside it, a
    hand loop of ``env.step`` + ``rollout.reset_done`` from the same state on
    a generator in the same state -> ({output: all torch.equal}, reset
    steps of the hand loop, the wrapper's last obs dict).  The wrapper adds
    nothing iff every output is equal."""
    import torch

    from red_gym_tpu_torch import env as envlib, rollout

    gen = torch.Generator(device=vec.device)
    gen.set_state(vec.gen.get_state())
    state = vec.states
    same = dict.fromkeys(("obs", "reward", "done", "checkpoint_done", "final_obs", "state"),
                         True)
    resets = 0
    for a in actions:
        w_obs, w_rew, w_done, w_info = vec.step(a)
        state, obs, reward, done, info = envlib.step(vec.cfg, vec.params, state, a, gen)
        final = obs
        if vec.auto_reset:
            state, obs, reset_any = rollout.reset_done(vec.cfg, vec.params, state, obs,
                                                       done, gen)
            resets += reset_any
        eq = lambda d, nt: all(torch.equal(d[k], getattr(nt, k))  # noqa: E731
                               for k in nt._fields)
        same["obs"] &= eq(w_obs, obs)
        same["reward"] &= torch.equal(w_rew, reward)
        same["done"] &= torch.equal(w_done, done)
        same["checkpoint_done"] &= torch.equal(w_info["checkpoint_done"],
                                               info["checkpoint_done"])
        same["final_obs"] &= eq(w_info["final_obs"], final)
        same["state"] &= all(torch.equal(a_, b_) for a_, b_ in zip(vec.states, state)
                             if b_ is not None)
    return same, resets, w_obs


def vec_env_phase(dev, profile: bool):
    """[vec_env]: ``red_gym_tpu_torch.make_vec`` at the main path's shapes,
    the library-default fast scan -> (launch counts, the env, its last obs
    dict).  ``profile``: device ops and busy time of 5 more steps."""
    import torch

    import red_gym_tpu_torch
    from red_gym_tpu_torch import assets, env as envlib, vec_env

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vec = red_gym_tpu_torch.make_vec(assets.named_map_yaml(TRACK), ENVS, num_agents=AGENTS,
                                     scan_mode="fast", return_final_obs=True)
    torch.cuda.synchronize()
    say("vec_env", f"make_vec({TRACK}, {ENVS}, num_agents={AGENTS}, scan_mode='fast', "
        f"return_final_obs=True): {vec.cfg.num_beams} beams, {vec.cfg.dtype}, on "
        f"{vec.device}; {time.perf_counter() - t0:.2f} s (map, EDT, texture marched on "
        f"the card)")
    lo, hi = (torch.as_tensor(b, device=dev) for b in envlib.action_bounds(vec.params.vehicle))
    agen = torch.Generator(device=dev).manual_seed(2)
    parts = (WARMUP_STEPS, STEPS, VEC_NUMPY_STEPS, PROFILE_STEPS, VEC_HAND_STEPS)
    acts = lo + (hi - lo) * torch.rand((sum(parts), ENVS, AGENTS, 2), generator=agen,
                                       device=dev)
    warm_acts, timed_acts, numpy_acts, prof_acts, hand_acts = torch.split(acts, parts)
    vec.reset(assets.waypoint_start_poses(TRACK, AGENTS))
    for a in warm_acts:
        vec.step(a)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    dones = []
    t0 = time.perf_counter()
    for a in timed_acts:
        dones.append(vec.step(a)[2])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    dones = torch.stack(dones)
    resets = int(dones.any(dim=1).sum())
    say("vec_env", f"{STEPS} steps of {ENVS} envs x {AGENTS} agents x {vec.cfg.num_beams} "
        f"beams, random actions within the vehicle's action bounds, auto-reset, "
        f"final_obs: {seconds:.3f} s, {ENVS * STEPS / seconds:.0f} env-steps/s "
        f"({1e3 * seconds / STEPS:.3f} ms/step), peak device memory "
        f"{peak / 2**30:.2f} GiB; {int(dones.sum())} episodes ended, {resets} of {STEPS} "
        f"steps reset some env; launches {counts}")
    check_counts("vec_env", counts, ("mega_edge_ttc[opp]", "prestep"), STEPS + resets)
    t0 = time.perf_counter()
    for a in numpy_acts:
        vec_env.numpy_step(*vec.step(a))
    seconds = time.perf_counter() - t0
    say("vec_env", f"the same loop with every step's obs, final_obs, reward and dones "
        f"copied to numpy (vec_env.numpy_step, what gym_vector.F110VectorEnv returns): "
        f"{VEC_NUMPY_STEPS} steps, {ENVS * VEC_NUMPY_STEPS / seconds:.0f} env-steps/s "
        f"({1e3 * seconds / VEC_NUMPY_STEPS:.3f} ms/step)")
    if profile:
        dones = []
        ops, busy, _ = device_busy(lambda: dones.extend(vec.step(a)[2] for a in prof_acts))
        say("profile:vec_env", f"{PROFILE_STEPS} steps ({sum(bool(d.any()) for d in dones)} "
            f"reset steps): {ops / PROFILE_STEPS:.0f} device ops, device busy "
            f"{busy / PROFILE_STEPS:.2f} ms a step")
    same, hand_resets, obs = vec_hand_loop(vec, hand_acts)
    say("vec_env", f"{VEC_HAND_STEPS} steps against env.step + rollout.reset_done on a "
        f"generator of the same state ({hand_resets} reset steps): torch.equal {same}")
    if not all(same.values()):
        fail(f"vec_env: the wrapper differs from the hand loop: {same}")
    if hand_resets == 0:
        fail("vec_env: no auto-reset in the hand-loop window")
    scans = obs["scans"]
    if not torch.isfinite(scans).all() or tuple(scans.shape) != (ENVS, AGENTS, BEAMS):
        fail(f"vec_env: scans {tuple(scans.shape)}, finite {bool(torch.isfinite(scans).all())}")
    return counts, vec, obs


def debug_phase(vec, obs_dict, dev) -> None:
    """[debug]: check_state on the [vec_env] states, then NaN in x and in
    start_pose on 1 % of the envs, and quarantine_reset."""
    import torch

    from red_gym_tpu_torch.env import Observation
    from red_gym_tpu_torch.utils import debug

    cfg, params, state = vec.cfg, vec.params, vec.states
    rep = {k: int(v) for k, v in debug.check_state(cfg, params, state).items()}
    say("debug", f"check_state on the {ENVS} envs of [vec_env]: {rep}")
    if any(rep.values()):
        fail(f"debug: check_state reports violations on healthy states: {rep}")
    g = torch.Generator(device=dev).manual_seed(3)
    bad = torch.randperm(ENVS, generator=g, device=dev)[:max(1, int(POISON_SHARE * ENVS))]
    x, start = state.x.clone(), state.start_pose.clone()
    x[bad, 0, 3] = float("nan")
    start[bad, 1, 2] = float("nan")
    poisoned = state._replace(x=x, start_pose=start)
    obs = Observation(**{k: obs_dict[k] for k in Observation._fields})
    n_bad = int(debug.check_state(cfg, params, poisoned)["nonfinite"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fixed, fobs, healthy = debug.quarantine_reset(cfg, params, poisoned, obs, vec.gen)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    want = torch.ones(ENVS, dtype=torch.bool, device=dev)
    want[bad] = False
    flagged_exactly = torch.equal(healthy, want)
    finite = bool(torch.isfinite(fixed.x[bad]).all() and torch.isfinite(fixed.start_pose).all())
    untouched = all(torch.equal(a[healthy], b[healthy])
                    for a, b in [*zip(fixed, poisoned), *zip(fobs, obs)] if b is not None)
    after = {k: int(v) for k, v in debug.check_state(cfg, params, fixed).items()}
    say("debug", f"{len(bad)} envs poisoned (NaN in x and in start_pose; {n_bad} non-finite "
        f"values): quarantine_reset {ms:.1f} ms; flagged exactly those {flagged_exactly}, "
        f"restarted finite {finite}, every other env torch.equal {untouched}; check_state "
        f"after {after}")
    if not (flagged_exactly and finite and untouched) or any(after.values()):
        fail("debug: quarantine_reset did not restart exactly the poisoned envs")


def gym_compat_phase(dev, profile: bool) -> dict:
    """[gym_compat]: the reference script's loop (examples/waypoint_follow.py:
    272-287) through gym_compat.make: one env of two cars in SimConfig's
    default exact scan on the card, both driven by pure pursuit on the host
    -> launch counts.  ``profile``: device ops and busy time of 5 more
    steps."""
    import numpy as np
    import torch

    from red_gym_tpu_torch import assets, gym_compat
    from red_gym_tpu_torch.agents import pure_pursuit as pp

    env = gym_compat.make("f110_gym:f110-v0", map=assets.named_map_yaml(TRACK),
                          num_agents=AGENTS)
    if env.cfg.scan_mode != "exact" or env.device.type != "cuda":
        fail(f"gym_compat: {env.cfg.scan_mode} scan on {env.device}")
    wps = pp.load_waypoints_csv(assets.waypoints_csv(TRACK), device="cpu")
    ppp = pp.make_params(wps, vgain=COMPAT_VGAIN)
    traj, n_wp = wps[:, :2], wps.shape[0]

    def raceline_index(obs):
        px, py = (torch.as_tensor(obs[k], dtype=torch.float64) for k in ("poses_x", "poses_y"))
        return pp.nearest_point(px, py, traj)[3]

    def drive(obs):
        speed, steer = pp.plan(*(torch.as_tensor(obs[k], dtype=torch.float64)
                                 for k in ("poses_x", "poses_y", "poses_theta")), ppp)
        return env.step(np.stack([steer.numpy(), speed.numpy()], axis=-1))

    torch.cuda.synchronize()
    reset_launch_counts()
    obs, _, done, _ = env.reset(assets.waypoint_start_poses(TRACK, AGENTS))
    prev, advance, hits = raceline_index(obs), torch.zeros(AGENTS, dtype=torch.long), 0
    t0 = time.perf_counter()
    for i in range(COMPAT_STEPS):
        obs, reward, done, info = drive(obs)
        idx = raceline_index(obs)
        advance += torch.remainder(idx - prev + n_wp // 2, n_wp) - n_wp // 2
        prev = idx
        hits += int(obs["collisions"].sum())
        if done:
            break
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    steps = i + 1
    say("gym_compat", f"gym_compat.make('f110_gym:f110-v0', map={TRACK}, num_agents="
        f"{AGENTS}): one env, exact scan, {env.cfg.num_beams} beams, {env.cfg.dtype}, on "
        f"{env.device}; {steps} legacy 4-tuple steps with pure pursuit (vgain "
        f"{COMPAT_VGAIN}) on the host in {seconds:.2f} s: {steps / seconds:.1f} steps/s "
        f"(one env: host-bound, the card idles); raceline advance {advance.tolist()} of "
        f"{n_wp} waypoints, laps {obs['lap_counts'].tolist()}, collision flags {hits}; "
        f"launches {counts}")
    if done or hits:
        fail(f"gym_compat: a collision at step {steps} (collision flags {hits})")
    if int(advance[0]) < n_wp // 10:
        fail(f"gym_compat: the ego advanced {int(advance[0])} of {n_wp} waypoints")
    check_counts("gym_compat", counts, ("march[beams]",), steps + 1)
    if profile:
        box = [obs]
        ops, busy, _ = device_busy(lambda: [box.append(drive(box[-1])[0])
                                            for _ in range(PROFILE_STEPS)])
        say("profile:gym_compat", f"{PROFILE_STEPS} steps: {ops / PROFILE_STEPS:.0f} device "
            f"ops, device busy {1e3 * busy / PROFILE_STEPS:.1f} us a step")
    return counts


RASTER_ENVS = 64          # images of the [rasterize] phase: the bitmap trainer's envs
RASTER_CHECK_ENVS = 4     # of them drawn again on the CPU for the whole-call check
# the rasterizer's least work, one lane instruction an operation at
# LANE_OPS_PER_S: the fill 3 an edge (one y converted, each point's shared
# by two edges; the min and max of the two: the rows it crosses), 8 a
# crossing (row, edge) pair (the denominator's compare and select, three
# subtractions, a product, a division, a sum, and the crossing's place in
# the row) and 1 a pixel (its parity written), not the (row, edge) tests of
# a kernel that sweeps every edge; the draw 11 a sample of a segment whose
# endpoints differ (per coordinate a product, a fused multiply-add, a rint
# and a two-sided clip; the pixel index) and 1 a t (1 - t, shared by every
# segment), none for a one-pixel segment (its pixel alone)
FILL_EDGE_OPS, FILL_CROSS_OPS, FILL_PIXEL_OPS = 3, 8, 1
DRAW_SAMPLE_OPS, DRAW_T_OPS = 11, 1
SAC_PROFILE_STEPS = 3     # planning steps under torch.profiler in [sac_bitmap]
# the planning step's profiler ranges (agents/planning_env.py) and the policy's
PLAN_RANGES = ("sac/policy", "plan/mpc", "plan/env_step", "plan/bitmap", "plan/reward")
SAC_STEPS, SAC_UPDATE_AFTER, SAC_UPDATE_EVERY = 60, 20, 10


def raster_points(dev):
    """(scans (E, 1080), points (E, 600, 2) int32): RASTER_ENVS scans of the
    exact scan at random free poses of TRACK, and their 600 endpoints on
    256 x 256 at 10 px/m (lidar_to_bitmap's defaults)."""
    import torch

    from red_gym_tpu_torch import assets, env
    from red_gym_tpu_torch.config import SimConfig
    from red_gym_tpu_torch.ops import rasterize, scan

    cfg = SimConfig(num_agents=1, num_beams=BEAMS, dtype="float32")
    params = env.make_params(cfg, assets.named_map_yaml(TRACK), device=dev)
    gen = torch.Generator(device=dev).manual_seed(13)
    poses = map_free_poses(params.tmap, RASTER_ENVS, gen)[:, None]
    scans = scan.trace(poses, params.tables, params.tmap, cfg)[:, 0]
    return scans, rasterize.beam_endpoints(scans, 600, (256, 256), 10.0)


def fill_bound(points, h: int, w: int) -> dict:
    """The fill's bound: its least work counted on this run's polygons (a
    few operations an edge, a crossing (row, edge) pair and a pixel) against
    its bytes (points read, the mask written)."""
    import torch

    ys = points[..., 1].float()
    y2 = torch.roll(ys, -1, dims=-1)
    rows = torch.arange(h, dtype=torch.float32, device=points.device)[:, None]
    crossings = sum(int(((y[None] > rows) != (z[None] > rows)).sum()) for y, z in zip(ys, y2))
    n, k = points.shape[:2]
    ops = FILL_EDGE_OPS * n * k + FILL_CROSS_OPS * crossings + FILL_PIXEL_OPS * n * h * w
    return {**bound(nbytes(points) + n * h * w, lane=float(ops)), "crossings": crossings}


def draw_bound(starts, ends, t, h: int, w: int) -> dict:
    """The draw's bound: the samples of the segments whose endpoints differ
    in this run, DRAW_SAMPLE_OPS each, and DRAW_T_OPS a t, against its bytes
    (endpoints and t read, the mask written once)."""
    moving = int((starts != ends).any(-1).sum())
    samples = moving * t.numel()
    ops = DRAW_SAMPLE_OPS * samples + (DRAW_T_OPS * t.numel() if moving else 0)
    return {**bound(nbytes(starts, ends, t) + starts.shape[0] * h * w, lane=float(ops)),
            "samples": samples}


def segment_runs(starts, ends, t, h: int, w: int, images: int = 8) -> dict:
    """On the host, with the twin's arithmetic (draw_segments_reference):
    the runs of one pixel along the segments' samples (the stores a run test
    leaves) and the one-pixel segments, {"runs", "segments", "one_pixel"}."""
    import torch

    tt = t.cpu()[:, None]
    omt = (1.0 - tt).to(torch.float64)
    runs = 0
    for i in range(0, starts.shape[0], images):
        s = starts[i:i + images].cpu().reshape(-1, 1, 2).to(torch.float32)
        e = ends[i:i + images].cpu().reshape(-1, 1, 2).to(torch.float32)
        pts = (s.to(torch.float64) * omt + (e * tt).to(torch.float64)).to(torch.float32)
        pix = torch.round(pts).to(torch.int64)
        idx = pix[..., 1].clamp(0, h - 1) * w + pix[..., 0].clamp(0, w - 1)
        runs += int(idx.shape[0] + (idx[:, 1:] != idx[:, :-1]).sum())
    return {"runs": runs, "segments": starts.shape[0] * starts.shape[1],
            "one_pixel": int((starts == ends).all(-1).sum())}


def rasterize_phase(dev, reports) -> dict:
    """[rasterize]: the fill and segment kernels against their twins at
    RASTER_ENVS x 256 x 256 and at one image (FILL's fill and outline, RAYS'
    rays; one image takes other blocks and another draw instance); the
    outline's runs and distinct pixels from the twin on the host; times and
    bounds at RASTER_ENVS images and at one; lidar_to_bitmap on the card
    equal to the CPU's in all three modes -> {"fill_polygon": record,
    "draw_segments": record}, each with its one-image times under
    "one_image"."""
    import torch

    from red_gym_tpu_torch.ops import raster_kernels as rk, rasterize

    h = w = 256
    scans, pts = raster_points(dev)
    t = rk.segment_t(dev)
    rolled = torch.roll(pts, -1, dims=-2)
    center = torch.tensor([h // 2, w // 2], dtype=torch.int32, device=dev).expand_as(pts)
    n, k = pts.shape[:2]

    def against_twins(m: int):
        """Each kernel and its twin on the first m images -> (fill pair,
        {"outline": pair, "rays": pair}, {label: torch.equal})."""
        p = pts[:m]
        fill = rk.fill_polygon(p, (h, w)), rk.fill_polygon_reference(p, (h, w))
        drawn = {}
        for label, starts, ends in (("outline", p, rolled[:m]), ("rays", center[:m], p)):
            mk = rk.draw_segments(torch.zeros((m, h, w), dtype=torch.uint8, device=dev),
                                  starts, ends, t)
            drawn[label] = mk, rk.draw_segments_reference(torch.zeros_like(mk), starts, ends, t)
        torch.cuda.synchronize()
        return fill, drawn, {"fill": torch.equal(*fill),
                             **{label: torch.equal(*pair) for label, pair in drawn.items()}}

    (fill_k, fill_r), masks, checks = against_twins(n)
    share = {"inside": float(fill_k.float().mean()),
             **{label: float(m[0].float().mean()) for label, m in masks.items()}}
    say("rasterize", f"{n} scans x {BEAMS} beams of the exact scan on {TRACK}, {k} drawn on "
        f"{h} x {w}: kernels torch.equal to their twins {checks}; share of the canvas "
        f"{ {key: round(v, 4) for key, v in share.items()} }")
    if not all(checks.values()):
        fail(f"rasterize: a kernel differs from its twin: {checks}")
    if not 0.01 < share["inside"] < 0.99:
        fail("rasterize: degenerate fill")
    fill_1, masks_1, checks_1 = against_twins(1)
    say("rasterize", f"one image: kernels torch.equal to their twins {checks_1}")
    if not all(checks_1.values()):
        fail(f"rasterize: at one image a kernel differs from its twin: {checks_1}")

    few = scans[:RASTER_CHECK_ENVS]
    same = {}
    for mode in ("FILL", "POLYGON", "RAYS"):
        same[mode] = torch.equal(rasterize.lidar_to_bitmap(few, draw_mode=mode).cpu(),
                                 rasterize.lidar_to_bitmap(few.cpu(), draw_mode=mode))
    say("rasterize", f"lidar_to_bitmap on the card equal to the CPU's on {RASTER_CHECK_ENVS} "
        f"scans: {same}")
    if not all(same.values()):
        fail(f"rasterize: lidar_to_bitmap on the card differs from the CPU: {same}")

    runs = segment_runs(pts, rolled, t, h, w)
    distinct = masks["outline"][1].reshape(n, -1).sum(1, dtype=torch.int64)
    say("rasterize", f"outline (twin, on the host): {runs['segments']} segments, "
        f"{runs['one_pixel']} of one pixel, {runs['segments'] * t.numel()} samples in "
        f"{runs['runs']} runs of one pixel; distinct pixels an image: mean "
        f"{float(distinct.float().mean()):.1f}, {int(distinct.sum())} in all")
    rec = {}
    for label, m in (("", n), (" one image", 1)):
        p, r = pts[:m], rolled[:m]
        lims = fill_bound(p, h, w)
        say("rasterize", f"fill{label}: bound from {lims['crossings']} crossing (row, edge) "
            f"pairs of {m * h * k}: {lims['bound_ms']:.5f} ms by {lims['bound_by']}")
        rec_fill = timed(f"fill_polygon{label}", lambda p=p: rk.fill_polygon(p, (h, w)),
                         lambda p=p: rk.fill_polygon_reference(p, (h, w)),
                         {key: lims[key] for key in ("bound_ms", "bound_by")},
                         resources(reports, "fill_polygon"), ("fill_polygon_kernel",))
        canvas_k = torch.zeros((m, h, w), dtype=torch.uint8, device=dev)
        canvas_r = torch.zeros_like(canvas_k)
        draw_lims = draw_bound(p, r, t, h, w)
        say("rasterize", f"draw{label}: bound from {draw_lims['samples']} samples of the "
            f"segments whose endpoints differ: {draw_lims['bound_ms']:.5f} ms by "
            f"{draw_lims['bound_by']}")
        rec_draw = timed(f"draw_segments{label}",
                         lambda p=p, r=r, c=canvas_k: rk.draw_segments(c, p, r, t),
                         lambda p=p, r=r, c=canvas_r: rk.draw_segments_reference(c, p, r, t),
                         {key: draw_lims[key] for key in ("bound_ms", "bound_by")},
                         resources(reports, "draw_segments"), ("draw_segments_kernel",))
        if label:
            keep = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")
            rec["fill_polygon"]["one_image"] = {key: rec_fill[key] for key in keep}
            rec["draw_segments"]["one_image"] = {key: rec_draw[key] for key in keep}
        else:
            rec["fill_polygon"] = {"crossings": lims["crossings"], **rec_fill}
            rec["draw_segments"] = {"samples": draw_lims["samples"], **rec_draw, **runs,
                                    "distinct_pixels": int(distinct.sum())}
    rec["fill_polygon"]["max_abs_err"] = float(max(
        (a.int() - b.int()).abs().max() for a, b in ((fill_k, fill_r), fill_1)))
    rec["draw_segments"]["max_abs_err"] = float(max(
        (a.int() - b.int()).abs().max() for a, b in (*masks.values(), *masks_1.values())))
    return rec


def timed_updates(sac, times: list):
    """Wrap ``sac.update`` so that each call's time (between two
    synchronizes) and losses land in ``times``."""
    import torch

    update = sac.update

    def run(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = update(*a, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0, {k: float(v) for k, v in out[1].items()}))
        return out

    sac.update = run


def sac_iterations(label: str, trainer, module, uses: tuple, env_steps_per_step: int,
                   smi: str):
    """One warm-up and one update iteration of a SAC trainer ``module``'s
    ``iteration``, launch counts from 0: ``uses`` once a step and once a
    reset step, every other kernel 0; losses and rewards finite -> (counts,
    {collect env-steps/s, median ms an update, ...}), printed beside the
    card's ``smi`` line."""
    import torch

    from red_gym_tpu_torch.agents.sac import UPDATE_DIAGNOSTICS
    from red_gym_tpu_torch.utils.profiling import Metrics

    steps = trainer.args.steps_per_iter
    times = []
    timed_updates(trainer.sac, times)
    torch.cuda.synchronize()
    reset_launch_counts()
    out, resets = {}, 0
    for name, do_update in (("warm-up", False), ("update", True)):
        t0 = time.perf_counter()
        acc, r = module.iteration(trainer, do_update)
        means = {k: round(v, 6) for k, v in Metrics.means(acc).items()}
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0, means, r)
        resets += r
    counts = launch_counts()
    upd = sorted(s for s, _ in times)
    collect_s = out["warm-up"][0] + out["update"][0] - sum(upd)
    rate = 2 * steps * env_steps_per_step / collect_s
    # the median: the first updates also pay cuDNN's and the allocator's first calls
    upd_ms = 1e3 * upd[len(upd) // 2] if upd else math.nan
    say(label, f"warm-up iteration {out['warm-up'][0]:.2f} s {out['warm-up'][1]}, update "
        f"iteration {out['update'][0]:.2f} s {out['update'][1]}; {2 * steps} steps of "
        f"{env_steps_per_step} envs, {resets} reset steps; collection {rate:.0f} env-steps/s, "
        f"{len(times)} SAC updates, median {upd_ms:.2f} ms, first "
        f"{1e3 * times[0][0] if times else math.nan:.1f} ms ({smi}); launches {counts}")
    check_counts(label, counts, uses, 2 * steps + resets)
    diag = {k: out["update"][1][k] for k in UPDATE_DIAGNOSTICS}
    say(label, f"the update iteration's SAC diagnostics (means over its {steps} steps): {diag}")
    if not all(map(math.isfinite, diag.values())):
        fail(f"{label}: a SAC diagnostic is not finite: {diag}")
    losses = [v for _, ls in times for v in ls.values()]
    means = [v for _, m, _ in out.values() for v in m.values()]
    if not times or not all(map(math.isfinite, losses + means)):
        fail(f"{label}: non-finite losses or metrics ({len(times)} updates)")
    return counts, {"collect_env_steps_per_s": rate, "update_ms": upd_ms, "resets": resets,
                    "last_losses": times[-1][1]}


def sac_bitmap_phase(dev, smi: str):
    """[sac_bitmap]: train_sac_bitmap_scale at its defaults (full width),
    one warm-up and one update iteration; the replay's size and ptr; peak
    memory; a profile of SAC_PROFILE_STEPS planning steps -> (launch
    counts, the iterations' numbers)."""
    import torch
    from torch.profiler import record_function

    from red_gym_tpu_torch.examples import train_sac_bitmap_scale as tsb

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tr = tsb.build(tsb.parse_args(["--device", "cuda"]))
    torch.cuda.synchronize()
    args = tr.args
    say("sac_bitmap", f"{args.envs} envs, {args.bitmap} px, CNN {tr.sac.actor.compute_dtype}, "
        f"batch {args.batch_size}, replay {args.capacity} x 2 x {args.bitmap}^2 uint8 "
        f"({2 * tr.buf.obs.numel() / 1e9:.2f} GB), reward_mode {args.reward_mode}; build and "
        f"reset {time.perf_counter() - t0:.1f} s")
    if (args.envs, args.bitmap, tr.sac.actor.compute_dtype, tr.sac.actor.dense_0.in_features) \
            != (64, 256, torch.bfloat16, 25088):
        fail("sac_bitmap: the trainer's defaults are not the full-width SAL model")
    counts, rec = sac_iterations("sac_bitmap", tr, tsb,
                                 ("fill_polygon", "draw_segments", "march[beams]"), args.envs,
                                 smi)
    want = 2 * args.steps_per_iter * args.envs
    peak = torch.cuda.max_memory_allocated(dev)
    say("sac_bitmap", f"replay size {tr.buf.size}, ptr {tr.buf.ptr} (want {want}); peak device "
        f"memory {peak / 2**30:.2f} GiB; {smi}")
    if (tr.buf.size, tr.buf.ptr) != (want, want % args.capacity):
        fail("sac_bitmap: the replay's size or ptr is off")

    def steps():
        for _ in range(SAC_PROFILE_STEPS):
            with record_function("sac/policy"):
                act = tr.sac.select_action(tr.sstate, tr.ps.bitmap, tr.gen)
            tr.ps, *_ = tr.env.step(tr.ps, act, tr.gen)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0) / SAC_PROFILE_STEPS
    ops, busy, prof = device_busy(steps)
    # the ranges' own device-side annotations are device events too: not work
    annotations = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA and e.name in PLAN_RANGES]
    ops -= len(annotations)
    busy -= sum(e.time_range.elapsed_us() for e in annotations) / 1e3
    split = {name: [0.0, 0.0] for name in PLAN_RANGES}
    for e in prof.events():
        if e.name in split and e.device_type == torch.autograd.DeviceType.CPU:
            split[e.name][0] += e.cpu_time_total / 1e3 / SAC_PROFILE_STEPS
            split[e.name][1] += e.device_time_total / 1e3 / SAC_PROFILE_STEPS
    say("profile:sac_bitmap", f"a planning step of {args.envs} envs: "
        f"{ops / SAC_PROFILE_STEPS:.0f} device ops, device busy {busy / SAC_PROFILE_STEPS:.2f} ms, "
        f"wall {wall:.2f} ms without the profiler; by range, host / device ms under the profiler: "
        + ", ".join(f"{n} {h:.2f} / {d:.2f}" for n, (h, d) in split.items()))
    kernels = sorted((a for a in prof.key_averages()
                      if a.device_type == torch.autograd.DeviceType.CUDA
                      and a.key not in PLAN_RANGES),
                     key=lambda a: a.self_device_time_total, reverse=True)[:6]
    say("profile:sac_bitmap", "device events by time a step: " + "; ".join(
        f"{a.key[:60]} {a.self_device_time_total / 1e3 / SAC_PROFILE_STEPS:.2f} ms "
        f"x{a.count / SAC_PROFILE_STEPS:.0f}" for a in kernels))
    same_seed_twice("sac_bitmap", "sac_bitmap", REPRO_BITMAP_ITERS, tsb.main)
    return counts, rec


def sac_scale_phase(dev, smi: str):
    """[sac_scale]: train_sac_scale at 512 envs x 1080 beams, one warm-up
    and one update iteration; kernel 5 once a step and a reset step."""
    from red_gym_tpu_torch.examples import train_sac_scale as tss

    t0 = time.perf_counter()
    tr = tss.build(tss.parse_args(["--device", "cuda"]))
    if tr.cfg.scan_interp != "spectral" or tr.args.envs != 512:
        fail(f"sac_scale: not the spectral scan at 512 envs: {tr.cfg}")
    say("sac_scale", f"{tr.args.envs} envs x {tr.args.beams} beams, spectral fast scan; build "
        f"(texture marched on the card) and reset {time.perf_counter() - t0:.1f} s")
    return sac_iterations("sac_scale", tr, tss, ("theta_spectral_ttc",), tr.args.envs, smi)


def sac_phase(dev, smi: str) -> dict:
    """[sac]: train_sac's loop (one env) for SAC_STEPS steps with updates
    every SAC_UPDATE_EVERY after SAC_UPDATE_AFTER; the kernels once a step
    and a reset; the checkpoint restored torch.equal, the restored actor's
    mean action equal."""
    import tempfile

    import torch

    from red_gym_tpu_torch.examples import train_sac
    from red_gym_tpu_torch.utils import checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sac_actor_ckpt.pt")
        reset_launch_counts()
        t0 = time.perf_counter()
        tr = train_sac.main(["--episodes", "1", "--steps", str(SAC_STEPS), "--update-after",
                             str(SAC_UPDATE_AFTER), "--update-every", str(SAC_UPDATE_EVERY),
                             "--replay-capacity", "1000", "--save", path])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        got = checkpoint.restore(path, like=tr.sac.init(torch.Generator().manual_seed(123)))
    same = all(torch.equal(v, b.state_dict()[k]) for a, b in zip(tr.sstate, got)
               if isinstance(a, torch.nn.Module) for k, v in a.state_dict().items())
    same = same and all(torch.equal(v, b.state_dict()["state"][i][k])
                        for a, b in zip(tr.sstate, got) if not isinstance(a, torch.nn.Module)
                        for i, st in a.state_dict()["state"].items() for k, v in st.items())
    obs = tr.buf.obs[:4]
    act_same = torch.equal(tr.sac.select_action(tr.sstate, obs, evaluate=True),
                           tr.sac.select_action(got, obs, evaluate=True))
    say("sac", f"{tr.total_steps} steps in {tr.episodes} episode(s), {seconds:.1f} s with the "
        f"build ({smi}); replay {tr.buf.size}; checkpoint restored torch.equal {same}, mean "
        f"action equal {act_same}; launches {counts}")
    check_counts("sac", counts, ("fill_polygon", "draw_segments", "march[beams]"),
                 tr.total_steps + tr.episodes)
    if not (same and act_same):
        fail("sac: the restored SAC state differs from the saved one")
    return counts, tr


STACK_NAME = "multimap_pad"  # track_0019 padded to the multi-map stack's size
EDT_ROW_OPS = 8            # row pass: a load, a compare and the two squared distances a pixel
EDT_COL_OPS = 12           # column pass by a lower envelope of parabolas: an intersection
                           # (two products, three adds, a divide), its compare and the query's
                           # square, add and compare a pixel
TRACKGEN_SEED = 0
PARAM_POP, PARAM_BEAMS = 50, 64    # examples/param_search_cma.py's width
PARAM_STEPS = 500          # one generation, cut from the example's 15 x 4500 steps
PARAM_CHECK_STEPS = 300    # the float32 race whose poses hold the march kernel to its twin
PARAM_F64_POP, PARAM_F64_STEPS = 4, 200
FAST64_STEPS = 50
FAST64_CHECK_ENVS = 256
EXPORT_BATCHES = (1, 7)
RACE_STEPS = 200


def edt_bound(occ, out) -> dict:
    """The exact EDT's bound on one map, for the two kernels that are
    timed: the uint8 zero mask that ``edt_transform`` hands them (a byte a
    pixel) read once and the output written once, against the linear work
    of the function (the row pass's EDT_ROW_OPS and a per-column lower
    envelope's EDT_COL_OPS a pixel, one lane instruction each at
    LANE_OPS_PER_S).  The occupancy's read and the mask's build come before
    the launches and are not timed.  D1's write and read (8 bytes a pixel)
    are the two-pass design's traffic, not the function's: they stand apart
    as ``d1_bytes_ms``, outside the bound."""
    h, w = occ.shape
    return {**bound(h * w + nbytes(out), lane=(EDT_ROW_OPS + EDT_COL_OPS) * h * w),
            "d1_bytes_ms": 1e3 * 2 * 4 * h * w / HBM_BYTES_PER_S}


EDT_KERNELS = ("edt_row_kernel", "edt_col_kernel")   # kernel E's two launches


def edt_long_searches(dev) -> dict:
    """The grids where an EDT's column search runs longest (1 free, 0
    wall): 2048 x 2048 walled only on its border (an open hall), 2048 x
    2048 with one zero pixel at (0, 0), and 1024 x 1024 all free (every
    column at JAX's sentinel)."""
    import torch

    hall = torch.ones((2048, 2048), dtype=torch.float32, device=dev)
    hall[[0, -1], :] = 0
    hall[:, [0, -1]] = 0
    one = torch.ones((2048, 2048), dtype=torch.float32, device=dev)
    one[0, 0] = 0
    return {"hall_2048": hall, "one_zero_2048": one,
            "free_1024": torch.ones((1024, 1024), dtype=torch.float32, device=dev)}


def edt_grid(path: str, dev, pad: tuple | None = None):
    """One EDT operand from a map's yaml ``path``: its occupancy (numpy,
    zero-padded, so walled, to ``pad`` = (H, W) where given), the same on
    ``dev`` and the map's resolution."""
    import numpy as np
    import torch

    from red_gym_tpu_torch.maps import loader

    occ = loader.load_map_image(path[:-len(".yaml")] + ".png")
    if pad is not None:
        occ = np.pad(occ, ((0, pad[0] - occ.shape[0]), (0, pad[1] - occ.shape[1])))
    return occ, torch.as_tensor(occ, device=dev), float(loader.read_map_yaml(path)["resolution"])


def edt_stack_size(maps: list) -> tuple:
    """The multi-map stack's padded size: the largest height and width of
    ``maps`` (yaml paths), 952 x 947 for the packaged tracks."""
    from red_gym_tpu_torch.maps import loader

    return tuple(map(max, zip(*(loader.load_map_image(p[:-len(".yaml")] + ".png").shape
                                for p in maps))))


def edt_phase(maps: list, dev, reports) -> dict:
    """[edt]: kernel E on each map of ``maps`` (yaml paths): torch.equal to
    its twin on the card, within scipy's bar (rtol 1e-6, atol 1e-5), and
    on track_0019 zero-padded to the stack's size (the largest height and
    width of the maps, 952 x 947 for the packaged tracks); on track_0019,
    the padded grid and a lone map its times, each kernel's device ms,
    bound, registers and spills, and scipy's host seconds beside them
    (set-up context, not a yardstick).  With track_0019 among the maps,
    also the long-search grids (``edt_long_searches``): torch.equal to the
    twin and each kernel's device ms."""
    import numpy as np
    import torch
    from scipy.ndimage import distance_transform_edt

    from red_gym_tpu_torch import assets
    from red_gym_tpu_torch.ops import edt_kernels

    timed_maps = {TRACK, STACK_NAME}
    rec = {}
    grids = [(p, None) for p in maps]
    if any(assets_name(p) == TRACK for p in maps):
        grids.append((assets.named_map_yaml(TRACK), edt_stack_size(maps)))
    for path, pad in grids:
        occ, o, res = edt_grid(path, dev, pad)
        got = edt_kernels.edt_transform(o, res)
        twin = edt_kernels.edt_reference(o, res)
        same = torch.equal(got, twin)
        t0 = time.perf_counter()
        want = distance_transform_edt(occ) * res
        host_s = time.perf_counter() - t0
        err = np.abs(got.cpu().numpy() - want)
        ok = bool(np.all(err <= 1e-5 + 1e-6 * np.abs(want)))
        name = STACK_NAME if pad is not None else assets_name(path)
        if len(maps) == 1:
            timed_maps.add(name)
        say("edt", f"{name} {occ.shape[0]}x{occ.shape[1]}: torch.equal to the twin {same}; "
            f"max |diff| to scipy {float(err.max()):.3e} m (bar met {ok}); scipy on the host "
            f"{host_s:.4f} s")
        if not (same and ok):
            fail(f"edt: {name}: the kernel differs from its twin or from scipy")
        if name in timed_maps and name not in rec:
            res_k = dict(resources(reports, "edt"))
            res_k["kernels"] = {fn: reports["edt"][fn] for fn in EDT_KERNELS}
            r = timed(f"edt {name}", lambda: edt_kernels.edt_transform(o, res),
                      lambda: edt_kernels.edt_reference(o, res), edt_bound(o, got), res_k,
                      EDT_KERNELS)
            say("edt", f"{name}: on the device row kernel "
                f"{r['device_ms_by_kernel']['edt_row_kernel']:.5f} ms + column kernel "
                f"{r['device_ms_by_kernel']['edt_col_kernel']:.5f} ms = "
                f"{r['device_ms']:.5f} ms, {100 * r['bound_ms'] / r['device_ms']:.1f} % of "
                f"the bound {r['bound_ms']:.5f} ms (D1's round trip alone "
                f"{r['d1_bytes_ms']:.5f} ms)")
            rec[name] = {**r, "max_abs_err": float((got - twin).abs().max()),
                         "shape": list(occ.shape), "scipy_host_s": host_s}
    if any(assets_name(p) == TRACK for p in maps):
        for name, o in edt_long_searches(dev).items():
            same = torch.equal(edt_kernels.edt_transform(o, 1.0),
                               edt_kernels.edt_reference(o, 1.0))
            ms = device_ms(lambda o=o: edt_kernels.edt_transform(o, 1.0), EDT_KERNELS)
            say("edt", f"{name} {o.shape[0]}x{o.shape[1]}: torch.equal to the twin {same}; on "
                f"the device row kernel {ms['edt_row_kernel']:.5f} ms + column kernel "
                f"{ms['edt_col_kernel']:.5f} ms = {ms['total']:.5f} ms")
            if not same:
                fail(f"edt: {name}: the kernel differs from its twin")
            rec[name] = {"shape": list(o.shape), "device_ms": ms.pop("total"),
                         "device_ms_by_kernel": ms}
    return rec


def edt_maps() -> list:
    """The packaged maps kernel E is held on: the 11 tracks, berlin, skirk."""
    from red_gym_tpu_torch import assets

    return assets.packaged_tracks() + [
        os.path.join(assets.DATA_DIR, "classic", f"{n}.yaml") for n in ("berlin", "skirk")]


def assets_name(path: str) -> str:
    return os.path.basename(path)[:-len(".yaml")]


def trackgen_phase(dev, profile: bool):
    """[trackgen]: a track generated on the host (maps.trackgen, seed 0),
    its map loaded with the device EDT (kernel E, once) and its texture
    marched on the card; then the default path at ENVS x AGENTS x BEAMS for
    STEPS steps from the generated CSV's waypoint starts: the megakernel
    with opponents and prestep once a step and reset step, every other
    kernel 0.  -> (counts of the load with the track's "yaml" path, counts
    of the path)."""
    import tempfile

    import torch

    from red_gym_tpu_torch import assets, env
    from red_gym_tpu_torch.config import SimConfig
    from red_gym_tpu_torch.maps import loader, trackgen

    tmp = tempfile.mkdtemp(prefix="trackgen_")
    t0 = time.perf_counter()
    yaml_path = trackgen.generate(tmp, seed=TRACKGEN_SEED)
    gen_s = time.perf_counter() - t0
    cfg = SimConfig(num_agents=AGENTS, num_beams=BEAMS, scan_mode="fast")
    reset_launch_counts()
    t0 = time.perf_counter()
    tmap = loader.load_map(yaml_path, dtype=cfg.tdtype, device=dev, edt_backend="device")
    params = env.make_params(cfg, yaml_path, tmap=tmap, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    load_counts = launch_counts()
    say("trackgen", f"{os.path.basename(yaml_path)}: {int(tmap.height)}x{int(tmap.width)} px "
        f"generated in {gen_s:.2f} s on the host; load_map(edt_backend='device') + "
        f"make_params (texture marched on the card) {setup_s:.2f} s; launches {load_counts}")
    if load_counts["edt"] != 1:
        fail(f"trackgen: the EDT kernel launched {load_counts['edt']} times, expected 1")
    counts = main_path("trackgen", cfg, params, dev, STEPS, ("mega_edge_ttc[opp]", "prestep"),
                       profile, start=assets.waypoint_start_poses(yaml_path, AGENTS))
    return {**load_counts, "yaml": yaml_path}, counts


def param_search_phase(dev):
    """[param_search]: tuning.search at examples/param_search_cma.py's
    configuration (popsize 50, 64 beams, float32 exact scan, RK4, dt 0.01,
    march_iters 32, no noise) on track_0019 for one generation of
    PARAM_STEPS steps: the march kernel once a step and the reset step,
    every other kernel 0, fitness finite; ms a step and rollouts/s; a
    torch.profiler summary of 5 evaluator steps; the march kernel
    torch.equal to its twin on the final float32 poses of a
    PARAM_CHECK_STEPS-step race of 50 candidates, and the race's scans
    equal to that twin; then the evaluator in float64 at popsize 4 x 200
    steps on the card and on the CPU.  200 steps (2 s) finish no lap, so
    each fitness is the budget plus a penalty: the race it is taken from
    is compared too, final state, scans and lap times within 1e-9, crash
    flags and toggles equal, and the fitness within 1e-9."""
    import dataclasses as dc

    import numpy as np
    import torch

    from red_gym_tpu_torch import assets
    from red_gym_tpu_torch.agents import pure_pursuit as pp
    from red_gym_tpu_torch.examples.param_search_cma import make_config
    from red_gym_tpu_torch.ops import march_kernels as mk
    from red_gym_tpu_torch.tuning import make_laptime_evaluator, search

    cfg = make_config(PARAM_BEAMS)
    yml = assets.named_map_yaml(TRACK)
    start = assets.waypoint_start_poses(TRACK, 1)[0]
    wpts = pp.load_waypoints_csv(assets.waypoints_csv(TRACK), dtype=torch.float32, device=dev)
    logs = []
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best, best_f = search(cfg, yml, wpts, start_pose=start, popsize=PARAM_POP, generations=1,
                          steps=PARAM_STEPS, log=logs.append, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    mean_f = float(logs[0].split("mean ")[1].split("s")[0])
    say("param_search", f"popsize {PARAM_POP} x {PARAM_BEAMS} beams, one generation of "
        f"{PARAM_STEPS} steps (the example runs 15 x 4500): {seconds:.2f} s with set-up, "
        f"{1e3 * seconds / PARAM_STEPS:.2f} ms a step, {PARAM_POP / seconds:.2f} rollouts/s; "
        f"{logs[0]}; best {best_f:.3f} s with {best}; launches {counts}")
    check_counts("param_search", counts, ("march[beams]",), PARAM_STEPS + 1)
    if not (np.isfinite(best_f) and np.isfinite(mean_f)):
        fail("param_search: non-finite fitness")

    pop = {"m": np.full(PARAM_POP, 3.74), "lf": np.full(PARAM_POP, 0.15875),
           "tlad": np.linspace(0.3, 3.0, PARAM_POP), "vgain": np.linspace(0.6, 1.4, PARAM_POP)}
    ev5 = make_laptime_evaluator(cfg, yml, wpts, PROFILE_STEPS, start, device=dev)
    ev5(pop)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev5(pop)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / PROFILE_STEPS
    ops, busy_ms, _ = device_busy(lambda: ev5(pop))
    say("profile:param_search", f"{PROFILE_STEPS} evaluator steps of {PARAM_POP} envs "
        f"(and its reset step): {ops} device ops ({ops / (PROFILE_STEPS + 1):.0f} a step), "
        f"device busy {busy_ms:.2f} ms ({busy_ms / (PROFILE_STEPS + 1):.3f} ms a step); "
        f"wall {wall_ms:.2f} ms a step without the profiler")

    ev = make_laptime_evaluator(cfg, yml, wpts, PARAM_CHECK_STEPS, start, device=dev)
    _, obs, crashed = ev.rollout(pop)
    poses = torch.stack([obs.poses_x, obs.poses_y, obs.poses_theta], dim=-1)
    tables, tmap = ev.params.tables, ev.params.tmap
    got = mk.march_beams(poses, tables.cosines, tables.sines, tmap, cfg)
    twin = mk.march_beams_reference(poses, tables.cosines, tables.sines, tmap, cfg)
    same, race_same = torch.equal(got, twin), torch.equal(obs.scans, twin)
    say("param_search", f"march on the final float32 poses of a {PARAM_CHECK_STEPS}-step race "
        f"of {PARAM_POP} candidates ({int(crashed.sum())} crashed; {tuple(poses.shape)} poses, "
        f"march_iters {cfg.march_iters}): kernel torch.equal to its twin {same}, the race's "
        f"scans torch.equal to the twin {race_same}")
    if not (same and race_same):
        fail("param_search: the march kernel differs from its twin on the evaluator's poses")

    c64 = dc.replace(cfg, dtype="float64")
    small = {k: v[:PARAM_F64_POP] for k, v in pop.items()}
    races = []  # the card's race, then the CPU's
    for d in (dev, torch.device("cpu")):
        w64 = pp.load_waypoints_csv(assets.waypoints_csv(TRACK), device=d)
        ev = make_laptime_evaluator(c64, yml, w64, PARAM_F64_STEPS, start, device=d)
        state, obs, crashed = ev.rollout(small)
        races.append({"fitness": ev.fitness(state, crashed), "x": state.x, "scans": obs.scans,
                      "lap_times": state.lap_times, "toggles": state.toggle_list,
                      "crashed": crashed})
    card, host = ({k: v.cpu() for k, v in r.items()} for r in races)
    diffs = {k: float((card[k] - host[k]).abs().max())
             for k in ("fitness", "x", "scans", "lap_times")}
    flags = all(torch.equal(card[k], host[k]) for k in ("toggles", "crashed"))
    say("param_search", f"float64 evaluator, popsize {PARAM_F64_POP} x {PARAM_F64_STEPS} "
        f"steps, card against CPU: fitness card {card['fitness'].tolist()}, CPU "
        f"{host['fitness'].tolist()}; max |diff| "
        + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items())
        + f"; toggles and crash flags equal {flags}")
    if not (flags and all(v <= 1e-9 for v in diffs.values())):
        fail(f"param_search: the float64 race differs between card and CPU: {diffs}, "
             f"flags equal {flags}")
    return counts, {"ms_per_step": 1e3 * seconds / PARAM_STEPS,
                    "rollouts_per_s": PARAM_POP / seconds, "profile_ops": ops,
                    "profile_busy_ms": busy_ms, "profile_wall_ms_per_step": wall_ms}


def to_cpu(params):
    """The same EnvParams with every tensor moved to the CPU."""
    def cpu(nt):
        return None if nt is None else type(nt)(*[None if v is None else v.cpu() for v in nt])
    return params._replace(vehicle=cpu(params.vehicle), tables=cpu(params.tables),
                           tmap=cpu(params.tmap), rtex=cpu(params.rtex),
                           noise_pool=None if params.noise_pool is None
                           else params.noise_pool.cpu())


def fast64_phase(params32, dev, profile: bool) -> None:
    """[fast64]: the default config in float64 (its texture marched in
    float64 on the card) for FAST64_STEPS timed steps at ENVS x AGENTS x
    BEAMS, no scan kernel; the first 256 envs' scans at the end equal the
    same float64 call on the CPU (the card's texture moved there) within
    1e-9 m; then scan_backend="xla" in float32 on the default texture for
    FAST64_STEPS steps, no scan kernel, and one step of it at the float32
    scan bar against one default-path step (its e/w taps in float32, as
    the XLA tail's) from the same state, actions and noise rows."""
    import dataclasses as dc

    import torch

    from red_gym_tpu_torch import assets, env
    from red_gym_tpu_torch.config import SimConfig
    from red_gym_tpu_torch.ops import scan_fast

    cfg = SimConfig(num_agents=AGENTS, num_beams=BEAMS, scan_mode="fast", dtype="float64")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = env.make_params(cfg, assets.named_map_yaml(TRACK), device=dev)
    torch.cuda.synchronize()
    say("fast64", f"float64 make_params (texture marched in float64 on the card): "
        f"{time.perf_counter() - t0:.2f} s, rt {tuple(params.rtex.rt.shape)} "
        f"{params.rtex.rt.dtype}")
    out = {}
    main_path("fast64", cfg, params, dev, FAST64_STEPS, (), profile, out=out)
    state = out["carry"].state
    poses = state.x[:FAST64_CHECK_ENVS][..., [0, 1, 4]]
    got = scan_fast.trace_fast_mxu(poses, params.tables, params.tmap, params.rtex, cfg)
    cp = to_cpu(params)
    want = scan_fast.trace_fast_mxu(poses.cpu(), cp.tables, cp.tmap, cp.rtex, cfg)
    diff = float((got.cpu() - want).abs().max())
    say("fast64", f"scans of the first {FAST64_CHECK_ENVS} envs, card against CPU: max |diff| "
        f"{diff:.3e} m")
    if not diff <= 1e-9:
        fail(f"fast64: the card's float64 scans differ from the CPU's by {diff} m")
    del params, cp, out, state

    xla = SimConfig(num_agents=AGENTS, num_beams=BEAMS, scan_mode="fast", scan_backend="xla")
    out = {}
    main_path("xla", xla, params32, dev, FAST64_STEPS, (), False, out=out)
    state = out["carry"].state
    # the XLA tail keeps the scan dtype for the e/w taps ("auto", as JAX
    # off a TPU does); the default path's kernels take them in bfloat16 on
    # the card, so the reference step takes them in float32 too
    default = dc.replace(xla, scan_backend="auto", rt_ew_dtype="float32")
    act = torch.stack([torch.full((ENVS, AGENTS), 0.1, device=dev),
                       torch.full((ENVS, AGENTS), 3.0, device=dev)], dim=-1)
    obs = {}
    for label, c in (("xla", xla), ("default", default)):
        gen = torch.Generator(device=dev).manual_seed(7)
        _, o, *_ = env.step(c, params32, state, act, gen)
        obs[label] = o
    bar_hit = (obs["xla"].collisions.reshape(-1), obs["default"].collisions.reshape(-1))
    scan_bar("xla against default, one step", obs["xla"].scans.reshape(-1, BEAMS), None,
             obs["default"].scans.reshape(-1, BEAMS), None, float(params32.rtex.cell))
    if not torch.equal(*bar_hit):
        fail("xla: the collision flags differ from the default path's")


def export_phase(ppo_policy, sac_actor, sac_obs, ppo_obs, dev) -> dict:
    """[export]: the PPO phase's trained ScanPolicy head exported with a
    symbolic batch on the card (utils.export), saved and loaded: 16384 scans
    served within 1e-6 of the direct head, ms a batch; batches of 1 and 7
    from the same artifact; a RACE_STEPS-step race driven by the loaded
    program (examples/export_policy.py --race, track_0019); the SAC phase's
    actor through the same round trip."""
    import tempfile

    import torch

    from red_gym_tpu_torch.agents import ppo as ppolib
    from red_gym_tpu_torch.examples import export_policy
    from red_gym_tpu_torch.utils import export as ex

    scans = ppo_obs.scans[:, 0].float().contiguous()
    vels = ppo_obs.linear_vels_x[:, 0].float().contiguous()
    head = ex.deterministic_ppo_control(ppo_policy, ppolib.PPOConfig())
    tmp = tempfile.mkdtemp(prefix="export_")
    path = os.path.join(tmp, "racer.pt2")
    t0 = time.perf_counter()
    ex.save_policy(path, head, (scans[:1], vels[:1]), device=dev)
    racer = ex.load_policy(path).module()
    export_s = time.perf_counter() - t0
    res = {}
    with torch.no_grad():
        served = racer(scans, vels)
        direct = head(scans, vels)
        diff = float((served - direct).abs().max())
        ms = median_ms(lambda: racer(scans, vels), TIMING_REPS)
        direct_ms = median_ms(lambda: head(scans, vels), TIMING_REPS)
        for n in EXPORT_BATCHES:
            res[n] = float((racer(scans[:n], vels[:n]) - head(scans[:n], vels[:n])).abs().max())
    say("export", f"PPO head (hidden {ppo_policy.hidden}) exported, saved "
        f"({os.path.getsize(path) / 1e6:.2f} MB) and loaded in {export_s:.2f} s; served "
        f"{scans.shape[0]} scans: max |diff| to the direct head {diff:.3e}; "
        f"{ms:.4f} ms a batch (direct {direct_ms:.4f}); batches {list(res)}: max |diff| "
        f"{list(res.values())}")
    if not (diff <= 1e-6 and all(v <= 1e-6 for v in res.values())):
        fail("export: the served PPO program differs from the direct head")
    steps, laps, speed, crashes = export_policy.race(path, RACE_STEPS, TRACK, "fast", dev)
    if steps < 1 or speed != speed:
        fail("export: the race did not run")
    sac_head = ex.deterministic_sac_action(sac_actor)
    spath = os.path.join(tmp, "sac.pt2")
    ex.save_policy(spath, sac_head, (sac_obs[:1],), device=dev)
    with torch.no_grad():
        sdiff = float((ex.load_policy(spath).module()(sac_obs) - sac_head(sac_obs)).abs().max())
    say("export", f"SAC actor round trip on {sac_obs.shape[0]} observations: max |diff| "
        f"{sdiff:.3e}; race {steps} steps, laps {laps}, mean speed {speed:.2f} m/s, "
        f"collision steps {crashes}")
    if not sdiff <= 1e-6:
        fail("export: the served SAC program differs from the direct head")
    return {"serve_ms": ms, "direct_ms": direct_ms, "max_abs_err": diff}


def collect_lidar_phase(dev) -> dict:
    """[collect_lidar]: examples/collect_lidar_dataset.py at its defaults
    (64 episodes x 10 steps, 256 px, track_0019): the march kernel, the fill
    and the segment draw launched once a step (the march also at the
    reset), every other kernel 0; the npz with JAX's keys, shapes and
    dtypes."""
    import tempfile

    import numpy as np
    import torch

    from red_gym_tpu_torch.examples import collect_lidar_dataset as cld

    args = cld.parse_args([])
    path = os.path.join(tempfile.mkdtemp(prefix="lidar_"), "lidar_dataset.npz")
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cld.main(["--out", path, "--device", str(dev)])
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    e_n, t_n, px = args.episodes, args.steps, args.image_size
    want = {"bitmaps": ((t_n, e_n, px, px), np.uint8), "scans": ((t_n, e_n, BEAMS), np.float32),
            "actions": ((t_n, e_n, 2), np.float32), "spawns": ((e_n, 3), np.float32)}
    with np.load(path) as z:
        got = {k: (z[k].shape, z[k].dtype) for k in z.files}
    say("collect_lidar", f"{e_n} episodes x {t_n} steps x {px} px in {seconds:.2f} s with "
        f"set-up; npz {got}; launches {counts}")
    if got != want:
        fail(f"collect_lidar: npz {got}, expected {want}")
    for name, n in counts.items():
        expect = {"march[beams]": t_n + 1, "fill_polygon": t_n, "draw_segments": t_n}.get(name, 0)
        if n != expect:
            fail(f"collect_lidar: {name} launched {n} times, expected {expect}")
    return counts


# -- PR 15: the element-gather scan, data-parallel PPO, the last examples --

TRACE_CPU_ENVS = 256      # envs of [trace_fast] scanned again on the CPU
# bf16 e/w taps against a float32 render: p99 under half a cell and the
# 4-cell share under FAR_FRAC_TOL (tests/test_scan_fast.py::
# test_pallas_edge_epilogue_matches_xla)
BF16_TAP_P99_CELLS = 0.5
DIST_ITERS = 2            # train_ppo iterations of each [distributed] run
DIST_RANK_ENVS = 8192     # envs a rank of the spawned [distributed] runs
DIST_TIMEOUT = 600        # seconds a spawned rank may take
# the float32 bar of P ranks against one process: the envs' steps are the
# same per row, but the policy's products run on other row counts and the
# losses are sums in another order
DIST_LOSS_TOL = (1e-3, 1e-4)     # rtol, atol of each iteration's loss
DIST_CHECKSUM_RTOL = 1e-5        # of sum |params| after each iteration
SCAN_ERR_POSES = 64
# rows of [scan_error], card against CPU: the statistics of kernel and twin
# against one float64 oracle (which must be equal) may differ at the scan
# bar, so by about a millimetre and a few beams in ten thousand
SCAN_ERR_TOL = {"median": 0.002, "p90": 0.002, "p99": 0.02, "frac_gt_1cell": 0.002,
                "frac_gt_4cell": 0.002}
GEN_FLAGS = ["--iters", "2", "--envs", "4096", "--eval-envs-per-track", "128",
             "--eval-steps", "200"]
LIDAR_STEPS, LIDAR_EVERY = 400, 100


def counting_resets():
    """Wrap rollout.reset_done (as PPO.collect and make_rollout call it) to
    count the calls in which this process restarted some env of its own:
    -> the counter, a dict with "local"."""
    from red_gym_tpu_torch import rollout

    counter = {"local": 0}
    inner = rollout.reset_done

    def reset_done(cfg, params, state, obs, done, gen, *a, **k):
        counter["local"] += bool(done.any())
        return inner(cfg, params, state, obs, done, gen, *a, **k)

    rollout.reset_done = reset_done
    counter["undo"] = lambda: setattr(rollout, "reset_done", inner)
    return counter


def trace_fast_phase(cfg, params, leg_cfg, leg_params, dev) -> None:
    """[trace_fast]: scan_fast.trace_fast (the element-gather scan, plain
    PyTorch) at ENVS x AGENTS x BEAMS on random free poses against the
    plain megakernel's clean scans (zero noise and speed) and kernel 6
    (trace_fast_mxu without fused_ttc), both with float32 e/w taps (the
    gather's arithmetic), and, on the legacy texture, kernel 7, at the
    scan bar; the default megakernel (bf16 taps) against the gather at
    JAX's bf16-tap bar; then the first TRACE_CPU_ENVS envs on the CPU."""
    import torch

    from red_gym_tpu_torch.ops import scan_fast, scan_kernels

    gen = torch.Generator(device=dev).manual_seed(15)
    poses = random_free_poses(params, ENVS * AGENTS, gen).reshape(ENVS, AGENTS, 3)
    cell = float(params.rtex.cell)
    f32 = dataclasses.replace(cfg, rt_ew_dtype="float32")

    def mega_ops(c):
        return scan_fast.mega_operands(poses, params.tables, params.tmap, params.rtex, c,
                                       torch.zeros((ENVS, BEAMS), device=dev),
                                       torch.zeros((ENVS, AGENTS), device=dev))

    ops32, ops16 = mega_ops(f32), mega_ops(cfg)
    if ops32["ew_dtype"] != torch.float32 or ops16["ew_dtype"] != torch.bfloat16:
        fail(f"trace_fast: e/w taps {ops32['ew_dtype']}, {ops16['ew_dtype']}")
    reset_launch_counts()
    gather = scan_fast.trace_fast(poses, params.tables, params.tmap, params.rtex, cfg)
    mega, _ = scan_kernels.mega_edge_ttc(**ops32)
    k6 = scan_fast.trace_fast_mxu(poses, params.tables, params.tmap, params.rtex, f32)
    leg_gather = scan_fast.trace_fast(poses, leg_params.tables, leg_params.tmap,
                                      leg_params.rtex, leg_cfg)
    k7 = scan_fast.trace_fast_mxu(poses, leg_params.tables, leg_params.tmap,
                                  leg_params.rtex, leg_cfg)
    torch.cuda.synchronize()
    counts = launch_counts()
    for name, n in (("mega_edge_ttc[plain]", 1), ("theta_shuffle_blend_edge", 1),
                    ("theta_shuffle_blend", 1)):
        if counts[name] != n:
            fail(f"trace_fast: {name} launched {counts[name]} times, expected {n}")
    flat = gather.reshape(-1, BEAMS)
    errs = {
        "megakernel (plain)": scan_bar("trace_fast: plain megakernel, float32 e/w taps, vs "
                                       "element gather", mega, None, flat, None, cell),
        "kernel 6": scan_bar("trace_fast: kernel 6, float32 e/w taps, vs element gather",
                             k6.reshape(-1, BEAMS), None, flat, None, cell),
        "kernel 7": scan_bar("trace_fast: kernel 7 (legacy texture) vs element gather",
                             k7.reshape(-1, BEAMS), None, leg_gather.reshape(-1, BEAMS),
                             None, float(leg_params.rtex.cell))}
    # the default's bf16 e/w taps move the ramp by up to a bf16 ulp of e
    # and w, which can flip a beam across a visibility edge: held to the
    # gather at JAX's bf16-tap bar (BF16_TAP_P99_CELLS, FAR_FRAC_TOL)
    mega16, _ = scan_kernels.mega_edge_ttc(**ops16)
    err16 = (mega16 - flat).abs().flatten()
    p99_16 = float(err16.sort().values[int(0.99 * (err16.numel() - 1))])
    far16 = float((err16 > 4 * cell).float().mean())
    if not torch.isfinite(mega16).all():
        fail("trace_fast: the default megakernel's scan has non-finite values")
    if p99_16 >= BF16_TAP_P99_CELLS * cell or far16 >= FAR_FRAC_TOL:
        fail(f"trace_fast: the default megakernel (bf16 e/w taps) is p99 {p99_16} m, "
             f"{far16} of beams past 4 cells from the element gather (bars "
             f"{BF16_TAP_P99_CELLS * cell} m, {FAR_FRAC_TOL})")
    gather_ms = median_ms(lambda: scan_fast.trace_fast(
        poses, params.tables, params.tmap, params.rtex, cfg), 5)
    mega_ms = median_ms(lambda: scan_kernels.mega_edge_ttc(**ops16), 5)
    cp = to_cpu(params)
    sub = poses[:TRACE_CPU_ENVS]
    cpu = scan_fast.trace_fast(sub.cpu(), cp.tables, cp.tmap, cp.rtex, cfg)
    scan_bar(f"trace_fast: card vs CPU, {TRACE_CPU_ENVS} envs", gather[:TRACE_CPU_ENVS]
             .reshape(-1, BEAMS).cpu(), None, cpu.reshape(-1, BEAMS), None, cell)
    say("trace_fast", f"{ENVS} x {AGENTS} x {BEAMS}: max |diff| against the element "
        f"gather {errs}; the default megakernel (bf16 e/w taps) p99 {p99_16:.3e} m, max "
        f"{float(err16.max()):.3e} m, {100 * far16:.4f}% beyond 4 cells; element gather "
        f"{gather_ms:.3f} ms a call (median of 5, plain PyTorch), plain megakernel "
        f"{mega_ms:.3f} ms")


def rank_worker(out: str, envs: int, iters: int, save: str) -> None:
    """One rank of a [distributed] run (``chip_smoke.py --rank-worker``,
    spawned with torchrun's variables): train_ppo's default config at
    ``envs`` global envs for ``iters`` iterations; writes to ``out`` its
    losses, checksums, kernel 4's launches, its own reset steps, the
    collectives' ms and the iterations' wall seconds."""
    import torch

    from red_gym_tpu_torch.examples import train_ppo
    from red_gym_tpu_torch.ops import _build
    from red_gym_tpu_torch.parallel import distributed as pdist, draws

    _build.build_all()
    pdist.initialize()
    dev = pdist.local_device()
    coll = {"ms": 0.0, "calls": 0}
    for name in ("all_reduce_sum", "gather_counts"):
        inner = getattr(draws, name)
        coll[name] = [0.0, 0]

        def timed_call(*a, _inner=inner, _name=name, **k):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            r = _inner(*a, **k)
            torch.cuda.synchronize(dev)
            ms = 1e3 * (time.perf_counter() - t0)
            coll["ms"] += ms
            coll["calls"] += 1
            coll[_name][0] += ms
            coll[_name][1] += 1
            return r

        setattr(draws, name, timed_call)
    resets = counting_resets()
    args = train_ppo.parse_args(["--envs", str(envs), "--iters", str(iters), "--save", save])
    reset_launch_counts()
    try:
        pstate, hist = train_ppo.run(args, dev, True)
        rec = {"rank": pdist.rank(), "world": pdist.world_size(),
               "backend": torch.distributed.get_backend(), "device": str(dev),
               "losses": [h["loss"] for h in hist], "wall_s": [h["wall_s"] for h in hist],
               "checksum": float(sum(p.detach().double().abs().sum()
                                     for p in pstate.policy.parameters())),
               "k4": launch_counts()["theta_shuffle_blend_edge_ttc_opp"],
               "local_resets": resets["local"], "collective_ms": coll["ms"],
               "collective_calls": coll["calls"],
               "by_collective": {k: coll[k] for k in ("all_reduce_sum", "gather_counts")},
               "reset_steps": [h["reset_steps"] for h in hist]}
    finally:
        pdist.shutdown()
    with open(out, "w") as f:
        json.dump(rec, f)


def spawn_ranks(n: int, envs: int, workdir: str) -> list:
    """``n`` ranks of ``rank_worker`` on this host (cuda:LOCAL_RANK modulo
    the cards) -> their records, in rank order.  Every rank is killed if
    one fails or the timeout passes."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    outs = [os.path.join(workdir, f"rank{r}.json") for r in range(n)]
    procs = []
    try:
        for r in range(n):
            env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       WORLD_SIZE=str(n), RANK=str(r), LOCAL_RANK=str(r),
                       LOCAL_WORLD_SIZE=str(n))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank-worker", outs[r],
                 "--worker-envs", str(envs), "--worker-save",
                 os.path.join(workdir, "ppo_shards")], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate(timeout=DIST_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        tail = "\n".join(log.strip().splitlines()[-8:])
        say("distributed", f"rank {r} exit {p.returncode}; last lines:\n{tail}")
        if p.returncode != 0:
            fail(f"distributed: rank {r} failed (exit {p.returncode})")
    return [json.load(open(o)) for o in outs]


def distributed_phase(dev, ranks: int, workdir: str) -> dict:
    """[distributed]: (1) a group of one over NCCL on cuda:0: one
    train_ppo-default iteration at ENVS envs through train_ppo.run's
    distributed branch, torch.equal to the same iteration without a group;
    (2) ``ranks`` spawned ranks (sharing cuda:0 over gloo on one card, a
    card each over NCCL on several) at DIST_RANK_ENVS envs each, DIST_ITERS
    iterations, against one process at the same global envs: loss and
    checksum at the float32 bar, kernel 4 launched once for the reset and
    collect steps + this rank's reset steps times on every rank, env-steps/s of the second
    iteration and the collectives' ms an iteration."""
    import torch

    from red_gym_tpu_torch.examples import train_ppo
    from red_gym_tpu_torch.parallel import distributed as pdist

    os.makedirs(workdir, exist_ok=True)

    def one(envs, iters, distributed):
        # a group's ranks write a shard directory, one process a file
        save = os.path.join(workdir, "ppo_world1" if distributed else "ppo_ckpt.pt")
        args = train_ppo.parse_args(["--envs", str(envs), "--iters", str(iters),
                                     "--save", save])
        reset_launch_counts()
        resets = counting_resets()
        try:
            pstate, hist = train_ppo.run(args, dev, distributed)
        finally:
            resets["undo"]()
        return pstate, hist, launch_counts()["theta_shuffle_blend_edge_ttc_opp"], resets

    rec = {}
    if torch.cuda.device_count() >= 1:
        pdist.initialize(device="cuda")
        backend = torch.distributed.get_backend()
        try:
            pa, ha, _, _ = one(ENVS, 1, True)
        finally:
            pdist.shutdown()
        pb, hb, _, _ = one(ENVS, 1, False)
        same = all(torch.equal(a, b) for a, b in zip(pa.policy.parameters(),
                                                     pb.policy.parameters()))
        same &= all(ha[0][k] == hb[0][k] for k in ("loss", "reward_mean", "done_rate",
                                                  "speed_mean", "reset_steps"))
        say("distributed", f"world size 1 over {backend} on {dev}: one iteration at "
            f"{ENVS} envs torch.equal to the ungrouped train_step: {same} (loss "
            f"{ha[0]['loss']:.6f})")
        if backend != "nccl" or not same:
            fail(f"distributed: world size 1 ({backend}) differs from the ungrouped step")
        rec["world1_backend"] = backend
        del pa, pb

    envs = DIST_RANK_ENVS * ranks
    torch.cuda.synchronize()
    ranks_rec = spawn_ranks(ranks, envs, workdir)
    ref, href, k4_ref, res_ref = one(envs, DIST_ITERS, False)
    ref_sum = float(sum(p.detach().double().abs().sum() for p in ref.policy.parameters()))
    ref_loss = [h["loss"] for h in href]
    steps = DIST_ITERS * train_ppo.parse_args([]).rollout
    for r in ranks_rec:
        dl = [abs(a - b) for a, b in zip(r["losses"], ref_loss)]
        dc = abs(r["checksum"] - ref_sum) / ref_sum
        say("distributed", f"rank {r['rank']} of {r['world']} ({r['backend']}, {r['device']}, "
            f"{envs // ranks} envs): losses {r['losses']} against one process's {ref_loss} "
            f"(|diff| {dl}); checksum {r['checksum']:.6f} against {ref_sum:.6f} "
            f"(relative {dc:.2e}); kernel 4 launched {r['k4']} = the reset + {steps} steps + "
            f"{r['local_resets']} own reset steps; collectives {r['collective_ms']:.1f} ms "
            f"in {r['collective_calls']} calls, {r['collective_ms'] / DIST_ITERS:.1f} ms an "
            f"iteration ([ms, calls] by function, the wait for the other ranks included: "
            f"{r['by_collective']})")
        rtol, atol = DIST_LOSS_TOL
        if any(d > atol + rtol * abs(b) for d, b in zip(dl, ref_loss)):
            fail(f"distributed: rank {r['rank']}'s losses differ from one process's")
        if dc > DIST_CHECKSUM_RTOL:
            fail(f"distributed: rank {r['rank']}'s parameters differ from one process's")
        if r["k4"] != 1 + steps + r["local_resets"]:
            fail(f"distributed: rank {r['rank']} launched kernel 4 {r['k4']} times, "
                 f"expected {1 + steps + r['local_resets']}")
        if r["losses"] != ranks_rec[0]["losses"] or r["checksum"] != ranks_rec[0]["checksum"]:
            fail("distributed: the ranks report different losses or parameters")
    if k4_ref != 1 + steps + res_ref["local"]:
        fail(f"distributed: one process launched kernel 4 {k4_ref} times")
    wall = max(r["wall_s"][-1] for r in ranks_rec)
    rate, rate1 = envs * 32 / wall, envs * 32 / href[-1]["wall_s"]
    say("distributed", f"{ranks} ranks x {envs // ranks} envs: the last iteration "
        f"{wall:.3f} s, {rate:.0f} env-steps/s in all; one process at {envs} envs "
        f"{href[-1]['wall_s']:.3f} s, {rate1:.0f} env-steps/s (same call)")
    # the ranks' shards hold the env states and observations: report their
    # size and remove them (a card's 16384 envs' scans alone are 141 MB)
    shard_mb = {}
    for name in ("ppo_world1", "ppo_shards"):
        d = os.path.join(workdir, name)
        shard_mb[name] = sum(os.path.getsize(os.path.join(r, f))
                             for r, _, fs in os.walk(d) for f in fs) / 1e6
        shutil.rmtree(d, ignore_errors=True)
    say("distributed", f"sharded checkpoints, MB (removed): {shard_mb}")
    rec.update(ranks=ranks, backend=ranks_rec[0]["backend"], env_steps_s=rate,
               one_process_env_steps_s=rate1,
               collective_ms_per_iter=[r["collective_ms"] / DIST_ITERS for r in ranks_rec],
               k4=[r["k4"] for r in ranks_rec], shard_mb=shard_mb)
    return rec


def profile_components_phase(dev) -> dict:
    """[profile_components]: examples/profile_components at ENVS envs, each
    phase's ms; kernel 1a and prestep launched once a call of the fast full
    step, kernel 6 once a call of the mxu scan (and once more for the
    phases' scans), the march once a call of the exact phases."""
    from red_gym_tpu_torch.examples import profile_components

    reps, ereps = 20, 2
    reset_launch_counts()
    ms = profile_components.main([str(ENVS), "--reps", str(reps), "--exact-reps", str(ereps)])
    # the texture's march is set-up (make_params), not a phase
    counts = {k: v for k, v in launch_counts().items() if k != "march[rays]"}
    say("profile_components", f"{ENVS} x {AGENTS} x {BEAMS}: ms a call {ms}; launches {counts}")
    want = {"mega_edge_ttc[opp]": reps + 1, "prestep": reps + 1,
            "theta_shuffle_blend_edge": reps + 2, "march[beams]": 2 * (ereps + 1)}
    for name, n in counts.items():
        if n != want.get(name, 0):
            fail(f"profile_components: {name} launched {n} times, expected "
                 f"{want.get(name, 0)}")
    return counts


def scan_error_phase(dev) -> dict:
    """[scan_error]: examples/scan_error_study on track_wide at 64 poses,
    its texture marched on the card; on the card the float64 oracle by the
    march kernel's double instance and the fast scans by kernels 6 and 7,
    the eager snap epilogue and the plain spectral product; then the same
    poses and texture on the CPU: the oracle equal, every row within
    SCAN_ERR_TOL."""
    import numpy as np
    import torch

    from red_gym_tpu_torch import assets
    from red_gym_tpu_torch.examples import scan_error_study as ses
    from red_gym_tpu_torch.maps.loader import load_map
    from red_gym_tpu_torch.ops.scan_fast import RangeTexture

    torch.set_float32_matmul_precision("highest")
    name = "track_wide"
    tmap64 = load_map(assets.named_map_yaml(name), ".png", dtype=torch.float64,
                      device="cpu")
    poses = ses.sample_poses(tmap64, SCAN_ERR_POSES, np.random.default_rng(0))
    full = ses.build_texture(name, 2, dev)
    reset_launch_counts()
    rows, exact = ses.study(poses, full, dev, name, 2, log=False)
    counts = launch_counts()
    for row in rows:
        say("scan_error", json.dumps(row))
    cpu_rows, cpu_exact = ses.study(poses, RangeTexture(*(t.cpu() for t in full)), "cpu",
                                    name, 2, log=False)
    d_oracle = float(np.abs(exact - cpu_exact).max())
    worst = {}
    for a, b in zip(rows, cpu_rows):
        for k, tol in SCAN_ERR_TOL.items():
            worst[k] = max(worst.get(k, 0.0), round(abs(a[k] - b[k]), 6))
            if abs(a[k] - b[k]) > tol:
                fail(f"scan_error: row {a} differs from the CPU's {b} in {k}")
    say("scan_error", f"card against CPU: oracle max |diff| {d_oracle:.3e} m; the rows' "
        f"largest |diff| {worst} (bars {SCAN_ERR_TOL}); launches {counts}")
    if d_oracle != 0.0:
        fail("scan_error: the card's float64 oracle differs from the CPU's")
    want = {"march[beams]": 1, "theta_shuffle_blend_edge": 4, "theta_shuffle_blend": 4}
    for k, n in counts.items():
        if n != want.get(k, 0):
            fail(f"scan_error: {k} launched {n} times, expected {want.get(k, 0)}")
    return counts


def generalization_phase(dev) -> dict:
    """[generalization]: examples/generalization_study cut to GEN_FLAGS:
    multi-map training on the 9 train tracks and the mean policy on all 11,
    kernel 1a launched once a step and a reset step (no prestep under
    map_idx), 11 rows finite in JAX's columns; the start-line crossing
    columns printed (NaN for a track whose egos did not cross)."""
    import math as m

    from red_gym_tpu_torch.examples import generalization_study

    reset_launch_counts()
    resets = counting_resets()
    t0 = time.perf_counter()
    try:
        rows = generalization_study.main(GEN_FLAGS)
    finally:
        resets["undo"]()
    seconds = time.perf_counter() - t0
    # the textures' marches are set-up (make_multimap_params), not the path
    counts = {k: v for k, v in launch_counts().items() if k != "march[rays]"}
    iters, rollout_len, eval_steps = 2, 32, 200
    # the training reset, the collect steps and their reset steps, the
    # evaluation's reset and steps
    want = 1 + iters * rollout_len + resets["local"] + 1 + eval_steps
    say("generalization", f"{' '.join(GEN_FLAGS)}: {seconds:.1f} s (two multi-map "
        f"make_params included); {resets['local']} reset steps; launches {counts}")
    check_counts("generalization", counts, ("mega_edge_ttc[opp]",), want)
    say("generalization", "start-line crossings of the evaluation, |lateral offset| (m) and "
        "the share outside the finish band: " + "; ".join(
            f"{r['track']} {r['cross_lat_abs_mean']} {r['cross_out_of_band']}" for r in rows))
    if len(rows) != 11 or not all(m.isfinite(r[k]) for r in rows
                                  for k in ("speed_mean", "crash_rate", "laps_mean")):
        fail(f"generalization: rows {rows}")
    return counts


def mpc_demo_phase(dev) -> None:
    """[mpc_demo]: examples/mpc_demo's built-in path on the card against
    the same run on the CPU: controls within 1e-4, the tracking error."""
    import numpy as np

    from red_gym_tpu_torch.examples import mpc_demo

    path, u_card, _, err = mpc_demo.main(["--device", "cuda"])
    _, u_cpu, _, err_cpu = mpc_demo.main(["--device", "cpu"])
    d = float(np.abs(u_card - u_cpu).max())
    say("mpc_demo", f"{u_card.shape[0]} steps along {path.shape[0]} waypoints: max |du| card "
        f"vs CPU {d:.2e}; tracking error {err:.4f} m (CPU {err_cpu:.4f} m)")
    if not (d <= 1e-4 and np.isfinite(err)):
        fail(f"mpc_demo: controls differ from the CPU's by {d}")


def lidar_bitmap_phase(dev, workdir: str) -> dict:
    """[lidar_bitmap]: examples/lidar_bitmap_example on the card, frames
    every LIDAR_EVERY steps: the march once a step and the reset, the fill
    once a FILL frame, the segment draw once a frame of each mode; every
    PNG decodes (maps.loader.read_png) to its frame."""
    import numpy as np

    from red_gym_tpu_torch.examples import lidar_bitmap_example
    from red_gym_tpu_torch.maps.loader import read_png

    reset_launch_counts()
    frames = lidar_bitmap_example.main(["--steps", str(LIDAR_STEPS), "--every",
                                        str(LIDAR_EVERY), "--outdir", workdir])
    counts = launch_counts()
    n = len(frames)
    for t, _, imgs in frames:
        for mode, img in imgs.items():
            png = read_png(os.path.join(workdir, f"{mode.lower()}_{t:05d}.png"))[0]
            if not np.array_equal(png, img):
                fail(f"lidar_bitmap: {mode} frame {t} does not decode to itself")
    say("lidar_bitmap", f"{n} frames x 3 modes written and decoded; launches {counts}")
    want = {"march[beams]": LIDAR_STEPS + 1, "fill_polygon": n, "draw_segments": 3 * n}
    for k, c in counts.items():
        if c != want.get(k, 0):
            fail(f"lidar_bitmap: {k} launched {c} times, expected {want.get(k, 0)}")
    return counts


# [draws]: the laws of the port's random draws.  Each law function takes a
# device and the sizes, draws through the port's own functions and returns
# its statistics, each beside its bar (``stat``); the statistic functions
# take the draws themselves, so that tests/test_torch_draws.py holds the
# JAX package's own draws of each law to the same bars on the CPU.  The
# laws, by label:
#   D1 env._make_noise_pool: N(0, sigma), bfloat16 storage in float32 runs;
#   D2 env._noise_rows, "pool" and "pool_rot" without the megakernel: one
#      row an env a step, uniform on [0, rows), an (E, B) slab;
#   D3 env._noise_rows, "pool_rot" with the megakernel: one offset a call,
#      uniform on the multiples of 16, env g on row (g + off) % rows;
#   D4 the reset step under "pool_rot" (rollout.reset_done): D3 with the
#      j-th done env for g;
#   D5 "fresh" scan noise and the exact scan's beam noise: N(0, sigma);
#   D6 rollout.reset_done(randomize_starts=...): maps uniform on the stack;
#   D7 rollout.random_policy: steer U(-0.4, 0.4), speed U(1, 8);
#   D8 PPO: action noise N(0, 1), an epoch's uniform permutation;
#   D9 SAC: sample_action's N(0, 1), replay indices uniform on [0, size).
DRAW_STEPS = 200          # steps of pool picks (D2): one pick an env a step
DRAW_CALLS = 4096         # pool_rot offsets (D3)
DRAW_RESET_CALLS = 2048   # reset steps under pool_rot (D4)
DRAW_RESET_DONE = 1500    # done envs of each, more than the pool's rows
DRAW_EXACT_POSES = 2048   # poses of the float64 exact scan's noise (D5)
DRAW_EPOCHS = 1024        # PPO epochs of the permutation law (D8)
DRAW_SAMPLES = 4096       # replay samples of each replay size (D9)
# the trainers' replays: train_sac_bitmap_scale's 25,000 (batch 64), full,
# and train_sac_scale's 200,000 (batch 256), three quarters filled
DRAW_REPLAYS = ((25_000, 25_000, 64), (200_000, 150_000, 256))
BEAM_MEAN_PICKS = 512     # T of JAX's per-beam mean (tests/test_infra.py:419-426)
CHI2_1024 = (800.0, 1300.0)  # JAX's band at 1024 pool rows (tests/test_infra.py:416)


def stat(name: str, value, bar: str, ok: bool) -> dict:
    """One statistic of a draw beside its bar."""
    return {"name": name, "value": value, "bar": bar, "ok": bool(ok)}


def below(name: str, value: float, limit: float) -> dict:
    return stat(name, value, f"< {limit:.6g}", value < limit)


def within(name: str, value: float, lo: float, hi: float) -> dict:
    return stat(name, value, f"in ({lo:.6g}, {hi:.6g})", lo < value < hi)


def equal(name: str, value, want) -> dict:
    return stat(name, value, f"== {want}", value == want)


def say_stat(s: dict) -> str:
    v = s["value"]
    return f"{s['name']} {v:.6g} {s['bar']}" if isinstance(v, float) else \
        f"{s['name']} {v} {s['bar']}"


def normal_stats(x, sigma: float) -> list:
    """N(0, sigma) at JAX's bars (tests/test_infra.py:406-407), in float64:
    |mean| < 4 sigma / sqrt(N) and |std - sigma| < 3 sigma / sqrt(2N - 2)."""
    flat = x.reshape(-1).double()
    n = flat.numel()
    return [below("|mean|", abs(float(flat.mean())), 4 * sigma / math.sqrt(n)),
            below("|std - sigma|", abs(float(flat.std(correction=0)) - sigma),
                  3 * sigma / math.sqrt(2 * n - 2))]


def chi2_counts(name: str, counts, band=None) -> dict:
    """chi^2 of bin counts against the uniform law, within ``band`` (by
    default k +- 5 sqrt(2k), k = bins - 1: 5 standard deviations)."""
    counts = counts.double()
    bins = counts.numel()
    expect = float(counts.sum()) / bins
    chi2 = float(((counts - expect) ** 2).sum()) / expect
    k = bins - 1
    lo, hi = band if band is not None else (k - 5 * math.sqrt(2 * k),
                                            k + 5 * math.sqrt(2 * k))
    return within(f"{name} chi2 ({bins} bins)", chi2, lo, hi)


def chi2_stat(name: str, values, bins: int, band=None) -> dict:
    """chi2_counts of integer ``values`` over [0, bins); a value outside
    that range fails the bar."""
    import torch

    counts = torch.bincount(values.reshape(-1).long(), minlength=bins)
    if counts.numel() > bins:
        return stat(f"{name} chi2 ({bins} bins)", "values outside the bins",
                    f"in [0, {bins})", False)
    return chi2_counts(name, counts, band)


def uniform_stats(name: str, x, lo: float, hi: float) -> list:
    """U(lo, hi): mean and variance (float64) within 5 standard errors of
    the law's, sqrt(w^2 / 12N) and w^2 / sqrt(180N) for w = hi - lo, and
    every draw in [lo, hi] (compared in the draw's own dtype)."""
    flat = x.reshape(-1).double()
    n, w = flat.numel(), hi - lo
    return [below(f"{name} |mean - mid|", abs(float(flat.mean()) - (lo + hi) / 2),
                  5 * w / math.sqrt(12 * n)),
            below(f"{name} |var - w^2/12|", abs(float(flat.var(correction=0)) - w * w / 12),
                  5 * w * w / math.sqrt(180 * n)),
            equal(f"{name} outside [{lo}, {hi}]", int(((x < lo) | (x > hi)).sum()), 0)]


def rotation_stats(rows, pos, pool_rows: int) -> list:
    """The pool_rot law of ``rows`` (calls, n), the pool rows that a call's
    n envs read: call c reads row (pos[j] + off_c) % pool_rows at its j-th
    env; the offsets off_c are multiples of 16, uniform over the
    pool_rows / 16 of them; a call reads each row floor or ceil(n /
    pool_rows) times (distinct rows for n <= pool_rows); and the last env's
    row is uniform over the rows of its class (pos[-1] mod 16) and never
    outside it."""
    import torch

    rows = rows.long()
    calls, n = rows.shape
    dev = rows.device
    pos = torch.as_tensor(pos, device=dev).long()
    off = (rows[:, 0] - pos[0]) % pool_rows
    wrong = int((rows != (pos[None, :] + off[:, None]) % pool_rows).sum())
    per_call = torch.bincount(
        (rows + pool_rows * torch.arange(calls, device=dev)[:, None]).reshape(-1),
        minlength=calls * pool_rows).reshape(calls, pool_rows)
    spread = int((per_call.max(1).values - per_call.min(1).values).max())
    last = torch.bincount(rows[:, -1], minlength=pool_rows)
    cls = (torch.arange(pool_rows, device=dev) - pos[-1]) % 16 == 0
    return [equal("rows off (pos + off) % rows", wrong, 0),
            equal("offsets off the multiples of 16", int((off % 16 != 0).sum()), 0),
            chi2_stat("offset / 16", off // 16, pool_rows // 16),
            below("a call's row-count spread (max - min)", spread, 2),
            equal("last env's rows off its class", int(last[~cls].sum()), 0),
            chi2_counts("last env's row in its class", last[cls])]


def pick_stats(picks, pool, sigma: float) -> list:
    """Pool row picks (steps x envs, flat), uniform on the pool's rows:
    chi^2 within JAX's band at 1024 rows, and the per-beam mean of the pool
    rows of the first 512 picks within 5 sigma / sqrt(512)
    (tests/test_infra.py:410-426)."""
    rows = pool.shape[0]
    beam_mean = pool[picks[:BEAM_MEAN_PICKS].long()].double().mean(dim=0)
    return [chi2_stat(f"{picks.numel()} picks", picks, rows,
                      CHI2_1024 if rows == 1024 else None),
            below(f"max |per-beam mean| of {BEAM_MEAN_PICKS} picks",
                  float(beam_mean.abs().max()), 5 * sigma / math.sqrt(BEAM_MEAN_PICKS))]


def permutation_stats(perms, minibatches: int) -> list:
    """Epoch permutations (an iterable of (n,) tensors): each a permutation
    of 0..n-1, and the minibatch (position // (n // minibatches)) of the
    first, middle and last sample uniform over the minibatches (chi^2)."""
    import torch

    bad, where = 0, []
    for perm in perms:
        n = perm.numel()
        picks = torch.tensor([0, n // 2, n - 1], device=perm.device)
        bad = bad + (torch.bincount(perm, minlength=n) != 1).any()
        pos = torch.empty_like(perm)
        pos[perm] = torch.arange(n, device=perm.device)
        where.append(pos[picks] // (n // minibatches))
    where = torch.stack(where)
    return [equal(f"epochs not a permutation of {n}", int(bad), 0),
            *(chi2_stat(f"sample {int(i)}'s minibatch", where[:, j], minibatches)
              for j, i in enumerate(picks))]


def index_stats(idx, filled: int) -> list:
    """Replay indices (-1 where a draw read past the filled part): none
    there, and uniform on [0, filled) (chi^2)."""
    return [equal(f"samples past the {filled} filled", int((idx < 0).sum()), 0),
            chi2_stat(f"{idx.numel()} indices", idx.clamp(min=0), filled)]


def draw_config(dev, **kw):
    """(cfg, params) of the port at ``kw``, with params of the exact scan on
    track_0019: the noise draws read only the params' pool and device, and
    the exact scan's params carry that pool without a range texture."""
    from red_gym_tpu_torch import assets, env
    from red_gym_tpu_torch.config import SimConfig

    cfg = SimConfig(**kw)
    params = env.make_params(dataclasses.replace(cfg, scan_mode="exact"),
                             assets.named_map_yaml(TRACK), device=dev)
    return cfg, params


def pool_law(dev, beams: int, rows: int, dtype: str) -> list:
    """D1: ``env._make_noise_pool``, rows x beams of N(0, sigma) under the
    fixed seed, stored in bfloat16 in float32 runs, float64 otherwise."""
    import torch

    from red_gym_tpu_torch import env
    from red_gym_tpu_torch.config import SimConfig

    cfg = SimConfig(num_beams=beams, dtype=dtype, noise_mode="pool", noise_pool_rows=rows)
    pool = env._make_noise_pool(cfg, dev)
    want = torch.bfloat16 if dtype == "float32" else torch.float64
    return [equal("storage", str(pool.dtype), str(want)),
            equal("shape", tuple(pool.shape), (rows, beams)),
            *normal_stats(pool, cfg.scan_noise_std)]


def pick_law(dev, envs: int, steps: int, beams: int, rows: int, noise_mode: str,
             seed: int) -> list:
    """D2: ``env._noise_rows`` under "pool", or "pool_rot" without the
    megakernel (the exact scan here): one pool row an env a step, uniform on
    [0, rows), as an (E, B) slab of the pool's storage dtype that the env's
    agents share.  The picks are read through a pool whose row r holds r;
    ``pick_stats`` of the ``steps`` x ``envs`` picks."""
    import torch

    from red_gym_tpu_torch import env

    cfg, params = draw_config(dev, num_beams=beams, noise_mode=noise_mode,
                              noise_pool_rows=rows)
    gen = torch.Generator(device=dev).manual_seed(seed)
    noise, off = env._noise_rows(cfg, params, envs, gen)
    labels = params._replace(noise_pool=torch.arange(
        rows, dtype=torch.float32, device=dev)[:, None].expand(rows, beams))
    picks, mixed = [], 0
    for _ in range(steps):
        lab, _ = env._noise_rows(cfg, labels, envs, gen)
        mixed += int((lab != lab[:, :1]).any(dim=1).sum())
        picks.append(lab[:, 0].long())
    return [equal("slab", (tuple(noise.shape), str(noise.dtype), off),
                  ((envs, beams), str(params.noise_pool.dtype), None)),
            equal("slab rows that are not one pool row", mixed, 0),
            *pick_stats(torch.cat(picks), params.noise_pool, cfg.scan_noise_std)]


def rotation_law(dev, envs: int, calls: int, beams: int, rows: int, seed: int) -> list:
    """D3: ``env._noise_rows`` under "pool_rot" with the megakernel: the
    whole pool and one offset a call, env g reading pool row
    ``scan_kernels.pool_rot_rows(envs, rows, off)[g]`` (as the kernel and
    its twin do), over ``calls`` calls."""
    import torch

    from red_gym_tpu_torch import env
    from red_gym_tpu_torch.ops import scan_fast, scan_kernels

    cfg, params = draw_config(dev, num_beams=beams, scan_mode="fast",
                              noise_mode="pool_rot", noise_pool_rows=rows)
    if not scan_fast.use_megakernel(cfg):
        fail("draws: the pool_rot law needs the megakernel's config")
    gen = torch.Generator(device=dev).manual_seed(seed)
    pools, offs = [], []
    for _ in range(calls):
        pool, off = env._noise_rows(cfg, params, envs, gen)
        pools.append(pool is params.noise_pool)
        offs.append(off)
    rot = torch.stack([scan_kernels.pool_rot_rows(envs, rows, o) for o in offs])
    return [equal("calls handing the kernel the whole pool", sum(pools), calls),
            *rotation_stats(rot, torch.arange(envs), rows)]


def reset_rotation_law(cfg, params, envs: int, done_n: int, calls: int,
                       seed: int) -> list:
    """D4: the reset step under "pool_rot" with the megakernel
    (``rollout.reset_done``, which steps the done envs alone): a fixed set
    of ``done_n`` of ``envs`` envs is done in each of ``calls`` calls, and
    each call's one draw of ``env._noise_rows`` is recorded.  The j-th done
    env reads row (j + off') % rows, off' a fresh offset a call.  The JAX
    package re-steps every env and keeps the done ones, so there done env
    g reads (g + off') % rows: the residue class differs, the law of the
    batch does not."""
    import torch

    from red_gym_tpu_torch import assets, env, rollout
    from red_gym_tpu_torch.ops import scan_kernels

    dev = params.tables.beam_cosines.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    poses = torch.as_tensor(assets.waypoint_start_poses(TRACK, cfg.num_agents),
                            dtype=cfg.tdtype, device=dev).expand(envs, -1, -1)
    state, obs, *_ = rollout.batched_reset(cfg, params, poses, gen)
    pick = torch.randperm(envs, generator=torch.Generator().manual_seed(seed))
    done = torch.zeros(envs, dtype=torch.bool)
    done[pick[:done_n]] = True
    done = done.to(dev)
    seen = []
    draw = env._noise_rows

    def recorded(*args):
        noise, off = draw(*args)
        seen.append((args[2], off))
        return noise, off

    env._noise_rows = recorded
    try:
        restarted = [rollout.reset_done(cfg, params, state, obs, done, gen)[2]
                     for _ in range(calls)]
    finally:
        env._noise_rows = draw
    rot = torch.stack([scan_kernels.pool_rot_rows(done_n, cfg.noise_pool_rows, off)
                       for _, off in seen])
    return [equal("reset steps", sum(restarted), calls),
            equal("draws, each of the done envs alone",
                  (len(seen), sorted({n for n, _ in seen})), (calls, [done_n])),
            *rotation_stats(rot, torch.arange(done_n), cfg.noise_pool_rows)]


def fresh_law(dev, envs: int, beams: int, seed: int) -> list:
    """D5: ``env._noise_rows`` under "fresh": an (E, B) slab of N(0, sigma)
    in the run's dtype, one row an env that its agents share."""
    import torch

    from red_gym_tpu_torch import env

    cfg, params = draw_config(dev, num_beams=beams, noise_mode="fresh")
    noise, off = env._noise_rows(cfg, params, envs,
                                 torch.Generator(device=dev).manual_seed(seed))
    return [equal("slab", (tuple(noise.shape), str(noise.dtype), off),
                  ((envs, beams), str(cfg.tdtype), None)),
            *normal_stats(noise, cfg.scan_noise_std)]


def exact_noise_law(dev, poses_n: int, beams: int, seed: int) -> list:
    """D5: ``ops.scan.scan``'s beam noise, the noisy scan less the clean
    one in float64 at random free poses: N(0, sigma) a beam."""
    import torch

    from red_gym_tpu_torch.ops import scan as scan_ops

    cfg, params = draw_config(dev, num_beams=beams, dtype="float64")
    gen = torch.Generator(device=dev).manual_seed(seed)
    poses = map_free_poses(params.tmap, poses_n, gen)
    noisy = scan_ops.scan(poses, gen, params.tables, params.tmap, cfg)
    clean = scan_ops.scan(poses, None, params.tables, params.tmap, cfg)
    return [equal("shape", tuple(noisy.shape), (poses_n, beams)),
            *normal_stats(noisy - clean, cfg.scan_noise_std)]


def map_draw_law(cfg, params, starts, envs: int, seed: int) -> list:
    """D6: ``rollout.reset_done(randomize_starts=starts)`` with every env
    done, on map-stacked params: each env's next map uniform on the M maps
    (chi^2), and each env restarted at ``starts[m]`` on its map m."""
    import torch

    from red_gym_tpu_torch import env, rollout

    dev = starts.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    m_n = starts.shape[0]
    midx = (torch.arange(envs, device=dev) % m_n).to(torch.int32)
    state, obs, *_ = env.reset(cfg, params, starts[midx.long()], gen, map_idx=midx)
    state, _, restarted = rollout.reset_done(
        cfg, params, state, obs, torch.ones(envs, dtype=torch.bool, device=dev), gen,
        randomize_starts=starts)
    m = state.map_idx.long()
    off = int((state.start_pose != starts[m.clamp(0, m_n - 1)]).flatten(1).any(1).sum())
    return [equal("restarted", restarted, True), chi2_stat(f"{envs} maps", m, m_n),
            equal("envs not at randomize_starts[m]", off, 0)]


def random_policy_law(dev, envs: int, agents: int, seed: int) -> list:
    """D7: ``rollout.random_policy``'s actions for (envs, agents) cars in
    float32: steer U(-0.4, 0.4), speed U(1, 8)."""
    import types

    import torch

    from red_gym_tpu_torch import rollout
    from red_gym_tpu_torch.config import SimConfig

    obs = types.SimpleNamespace(scans=torch.zeros((envs, agents, 1), device=dev))
    act = rollout.random_policy(SimConfig(num_agents=agents))(
        obs, torch.Generator(device=dev).manual_seed(seed))
    return [*uniform_stats("steer", act[..., 0], -0.4, 0.4),
            *uniform_stats("speed", act[..., 1], 1.0, 8.0)]


def ppo_law(dev, envs: int, steps: int, beams: int, epochs: int, seed: int) -> list:
    """D8: PPO's action noise, read back from ``PPO._policy_step``'s
    actions as (act - mean) / std, over ``steps`` steps of ``envs`` envs:
    N(0, 1); and ``agents.ppo.epoch_permutation`` over the steps x envs
    samples of that rollout in ``epochs`` epochs: ``permutation_stats``."""
    import types

    import torch

    from red_gym_tpu_torch.agents import ppo as ppo_lib

    cfg, params = draw_config(dev, num_beams=beams)
    ppo = ppo_lib.PPO(cfg, params)
    pstate = ppo.init(torch.Generator().manual_seed(seed))
    gen = torch.Generator(device=dev).manual_seed(seed)
    obs = types.SimpleNamespace(
        scans=10 * torch.rand((envs, cfg.num_agents, beams), generator=gen, device=dev),
        linear_vels_x=torch.zeros((envs, cfg.num_agents), device=dev))
    noise = []
    with torch.no_grad():
        for _ in range(steps):
            act, _, _, feat, _ = ppo._policy_step(pstate.policy, obs, pstate.gen)
            mean, log_std, _ = ppo._apply(pstate.policy, feat,
                                          obs.linear_vels_x[:, cfg.ego_idx])
            noise.append((act - mean) / torch.exp(log_std))
    perms = (ppo_lib.epoch_permutation(envs * steps, pstate.gen, dev)
             for _ in range(epochs))
    return [*normal_stats(torch.stack(noise), 1.0),
            *permutation_stats(perms, ppo.pcfg.minibatches)]


def sac_law(dev, n: int, capacity: int, filled: int, batch: int, samples: int,
            seed: int) -> list:
    """D9: ``agents.sac.sample_action``'s eps, read back as atanh of the
    action of an actor whose mean and log std are 0 (float64): N(0, 1); and
    ``ReplayBuffer.sample`` of a buffer of ``capacity`` with ``filled``
    transitions, labelled 1..filled by their reward, over ``samples``
    batches: ``index_stats``."""
    import torch

    from red_gym_tpu_torch.agents import sac

    gen = torch.Generator(device=dev).manual_seed(seed)
    act, _ = sac.sample_action(lambda o: (torch.zeros_like(o), torch.zeros_like(o)),
                               torch.zeros((n, 2), dtype=torch.float64, device=dev), gen)
    buf = sac.ReplayBuffer.create(capacity, (1,), 2, device=dev)
    buf.push_batch(torch.zeros((filled, 1), dtype=torch.uint8, device=dev),
                   torch.zeros((filled, 2), device=dev),
                   torch.arange(1, filled + 1, dtype=torch.float32, device=dev),
                   torch.zeros((filled, 1), dtype=torch.uint8, device=dev),
                   torch.zeros(filled, device=dev))
    idx = torch.cat([buf.sample(gen, batch)[2] for _ in range(samples)]).long() - 1
    return [*normal_stats(torch.atanh(act), 1.0), *index_stats(idx, filled)]


def draws_phase(dev, params) -> None:
    """[draws]: every law above at the main path's sizes (16384 envs x 2
    agents x 1080 beams, float32, a pool of 1024 rows); ``params`` are the
    default path's (track_0019, range texture), which the reset step of D4
    runs on.  One line a law, each statistic beside its bar; any miss
    fails, after every law has printed."""
    import torch

    from red_gym_tpu_torch import assets, env
    from red_gym_tpu_torch.config import SimConfig

    t0 = time.perf_counter()
    rows = SimConfig().noise_pool_rows
    rot_cfg = SimConfig(num_agents=AGENTS, num_beams=BEAMS, scan_mode="fast",
                        noise_mode="pool_rot")
    tracks = assets.packaged_tracks()
    mm_cfg = SimConfig(num_agents=AGENTS, num_beams=BEAMS)
    laws = [
        ("D1 pool, float32", lambda: pool_law(dev, BEAMS, rows, "float32")),
        ("D1 pool, float64", lambda: pool_law(dev, BEAMS, rows, "float64")),
        ("D2 pool picks", lambda: pick_law(dev, ENVS, DRAW_STEPS, BEAMS, rows, "pool", 1)),
        ("D2 pool_rot picks without the megakernel",
         lambda: pick_law(dev, ENVS, DRAW_STEPS, BEAMS, rows, "pool_rot", 2)),
        ("D3 pool_rot offsets", lambda: rotation_law(dev, ENVS, DRAW_CALLS, BEAMS, rows, 3)),
        ("D4 pool_rot reset steps",
         lambda: reset_rotation_law(rot_cfg, params, ENVS, DRAW_RESET_DONE,
                                    DRAW_RESET_CALLS, 4)),
        ("D5 fresh noise", lambda: fresh_law(dev, ENVS, BEAMS, 5)),
        ("D5 exact scan noise, float64",
         lambda: exact_noise_law(dev, DRAW_EXACT_POSES, BEAMS, 6)),
        (f"D6 randomize_starts on {len(tracks)} tracks",
         lambda: map_draw_law(mm_cfg, env.make_multimap_params(mm_cfg, tracks, device=dev),
                              torch.as_tensor(assets.start_pose_table(tracks, AGENTS),
                                              dtype=mm_cfg.tdtype, device=dev), ENVS, 7)),
        ("D7 random_policy", lambda: random_policy_law(dev, ENVS, AGENTS, 8)),
        ("D8 PPO", lambda: ppo_law(dev, ENVS, 32, BEAMS, DRAW_EPOCHS, 9)),
        *((f"D9 SAC, replay {cap} ({filled} filled, batch {batch})",
           functools.partial(sac_law, dev, ENVS * 32, cap, filled, batch, DRAW_SAMPLES,
                             10 + i))
          for i, (cap, filled, batch) in enumerate(DRAW_REPLAYS)),
    ]
    missed, n_stats = [], 0
    for label, law in laws:
        stats = law()
        n_stats += len(stats)
        say("draws", f"{label}: " + "; ".join(say_stat(s) for s in stats))
        missed += [f"{label}: {say_stat(s)}" for s in stats if not s["ok"]]
    torch.cuda.synchronize()
    say("draws", f"{len(laws)} laws, {n_stats} statistics, {len(missed)} missed; "
        f"{time.perf_counter() - t0:.1f} s; {nvidia_smi()}")
    if missed:
        fail("draws: " + " | ".join(missed))


ONLY_PHASES = ("trace_fast", "distributed", "profile_components", "scan_error",
               "generalization", "mpc_demo", "lidar_bitmap", "rasterize", "edt", "draws",
               "sac_bitmap", "sac_scale")


def only_phases(names, dev, ranks: int, workdir: str, kind: str, reports: dict) -> None:
    """``--only``: the named phases alone, then the last line."""
    import torch

    from red_gym_tpu_torch import assets, env
    from red_gym_tpu_torch.config import SimConfig

    bad = set(names) - set(ONLY_PHASES)
    if bad:
        fail(f"--only: unknown phases {sorted(bad)}; choose from {ONLY_PHASES}")
    if "trace_fast" in names:
        cfg = SimConfig(num_agents=AGENTS, num_beams=BEAMS, scan_mode="fast")
        leg_cfg = dataclasses.replace(cfg, rt_spatial="bilinear", rt_occlusion="off",
                                      rt_grad=False)
        track = assets.named_map_yaml(TRACK)
        trace_fast_phase(cfg, env.make_params(cfg, track, device=dev), leg_cfg,
                         env.make_params(leg_cfg, track, device=dev), dev)
    phases = {"distributed": lambda: distributed_phase(dev, ranks, workdir),
              "profile_components": lambda: profile_components_phase(dev),
              "scan_error": lambda: scan_error_phase(dev),
              "generalization": lambda: generalization_phase(dev),
              "mpc_demo": lambda: mpc_demo_phase(dev),
              "lidar_bitmap": lambda: lidar_bitmap_phase(
                  dev, os.path.join(workdir, "lidar_bitmaps")),
              "rasterize": lambda: rasterize_phase(dev, reports),
              "sac_bitmap": lambda: sac_bitmap_phase(dev, nvidia_smi()),
              "sac_scale": lambda: sac_scale_phase(dev, nvidia_smi()),
              "edt": lambda: edt_phase(edt_maps(), dev, reports),
              "draws": lambda: draws_phase(dev, env.make_params(
                  SimConfig(num_agents=AGENTS, num_beams=BEAMS, scan_mode="fast"),
                  assets.named_map_yaml(TRACK), device=dev))}
    for name in names:
        if name in phases:
            phases[name]()
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}),
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile 5 steps of the default, eager, bilinear, "
                         "ultra and exact paths")
    ap.add_argument("--only", type=str, default=None,
                    help="run only these comma-separated phases after the build: "
                         f"{','.join(ONLY_PHASES)}")
    ap.add_argument("--ranks", type=int, default=2,
                    help="ranks of [distributed]'s spawned run (2: sharing cuda:0 over "
                         "gloo on one card; on as many cards: a card each over NCCL)")
    ap.add_argument("--rank-worker", type=str, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--worker-envs", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--worker-save", type=str, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank_worker:
        rank_worker(args.rank_worker, args.worker_envs, DIST_ITERS, args.worker_save)
        return
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
    libs = _build.build_all()
    reports = {name: _build.ptxas_report(lib) for name, lib in libs.items()}
    for name, lib in libs.items():
        say("build", f"{name} -> {os.path.relpath(lib)}; " + " | ".join(
            f"{fn}: {r['regs']} registers, {r['spill_bytes']} spill bytes"
            for fn, r in reports[name].items()))
    say("build", f"nvcc build of {len(libs)} kernel(s), in parallel: "
        f"{time.perf_counter() - t0:.1f} s")

    # a cold texture build every run: its time is one of the reported numbers
    os.environ["RED_GYM_TPU_TEXTURE_CACHE"] = "off"
    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out",
                           "chip_smoke")
    if args.only:
        only_phases(args.only.split(","), dev, args.ranks, workdir, kind, reports)
        return
    cfg = SimConfig(num_agents=AGENTS, num_beams=BEAMS, scan_mode="fast")
    t0 = time.perf_counter()
    params = env.make_params(cfg, assets.named_map_yaml(TRACK), device=dev)
    torch.cuda.synchronize()
    rt = params.rtex.rt
    say("texture", f"{TRACK} stride {cfg.rt_pose_stride}: {int(params.rtex.hc)}x"
        f"{int(params.rtex.wc)} cells, rt {tuple(rt.shape)} {rt.dtype} "
        f"({rt.numel() * rt.element_size() / 1e6:.0f} MB); make_params (map, "
        f"EDT, texture marched on the card) {time.perf_counter() - t0:.1f} s")

    # the bilinear config (bench.py's "bilinear" mode) reads the same
    # texture: its channels do not depend on rt_spatial
    bil = dataclasses.replace(cfg, rt_spatial="bilinear")
    # bench.py's "legacy" mode: occlusion off, no grad channels, so a
    # 1-channel texture of its own, marched on the card; bench.py's "ultra"
    # (spectral theta, nearest1, occlusion off, no grad channels) reads
    # the same channels
    leg_cfg = dataclasses.replace(bil, rt_occlusion="off", rt_grad=False)
    ultra = dataclasses.replace(cfg, scan_interp="spectral", rt_occlusion="off",
                                rt_grad=False)
    t0 = time.perf_counter()
    leg_params = env.make_params(leg_cfg, assets.named_map_yaml(TRACK), device=dev)
    torch.cuda.synchronize()
    say("texture", f"legacy / ultra: rt {tuple(leg_params.rtex.rt.shape)}; make_params "
        f"{time.perf_counter() - t0:.1f} s")
    if ultra.rt_channels != leg_cfg.rt_channels:
        fail("the ultra and legacy configs must read the same texture channels")

    texture_phase(cfg, params.tmap)
    # kernel E on every packaged map (11 tracks, berlin, skirk) and, below,
    # on a generated track
    edt_rec = edt_phase(edt_maps(), dev, reports)
    exact_cfg = dataclasses.replace(cfg, scan_mode="exact")
    march = march_phase(exact_cfg, params, dev, reports)
    mega = mega_phase(cfg, params, dev, reports)
    pre = prestep_phase(cfg, params, dev, reports)
    blend = blend_phase(bil, params, dev, reports)
    spectral = spectral_phase(ultra, leg_params, dev, reports)

    # one params serve the configs of one texture: they differ in
    # noise_mode (the pool is built for "pool" and "pool_rot" alike), the
    # cell lookup and the kernel knobs
    default = main_path("default", cfg, params, dev, STEPS,
                        ("mega_edge_ttc[opp]", "prestep"), args.profile)
    rot = main_path("pool_rot", dataclasses.replace(cfg, noise_mode="pool_rot"),
                    params, dev, STEPS, ("mega_edge_ttc[opp+pool_rot]", "prestep"),
                    False)
    eager = main_path("eager", dataclasses.replace(cfg, state_kernel="off",
                                                   fuse_scan_opp="off"),
                      params, dev, STEPS, ("mega_edge_ttc[plain]",), args.profile)
    bilinear = main_path("bilinear", bil, params, dev, STEPS,
                         ("theta_shuffle_blend_edge_ttc_opp",), args.profile)
    bil_ttc = main_path("bilinear_opp_off", dataclasses.replace(bil, fuse_scan_opp="off"),
                        params, dev, STEPS, ("theta_shuffle_blend_edge_ttc",), False)
    bil_edge = main_path("bilinear_ttc_off", dataclasses.replace(bil, fuse_scan_ttc="off"),
                         params, dev, STEPS, ("theta_shuffle_blend_edge",), False)
    legacy = main_path("legacy", leg_cfg, leg_params, dev, STEPS,
                       ("theta_shuffle_blend",), False)
    ultra_counts = main_path("ultra", ultra, leg_params, dev, STEPS,
                             ("theta_spectral_ttc",), args.profile)
    main_path("ultra_ttc_off", dataclasses.replace(ultra, fuse_scan_ttc="off"),
              leg_params, dev, STEPS, (), False)
    # the exact scan: SimConfig's default scan mode, no texture
    exact_params = env.make_params(exact_cfg, assets.named_map_yaml(TRACK),
                                   tmap=params.tmap, device=dev)
    if exact_params.rtex is not None:
        fail("exact: make_params built a range texture")
    exact = main_path("exact", exact_cfg, exact_params, dev, STEPS, ("march[beams]",),
                      args.profile, max_step_ms=MARCH_STEP_MS)
    del exact_params

    # multi-map batches: every packaged track, stacked (train_ppo.py --multi-map)
    tracks = assets.packaged_tracks()
    setup, mm = {}, {}
    for name, c in (("exact", exact_cfg), ("default", cfg), ("ultra", ultra)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mm[name] = env.make_multimap_params(c, tracks, device=dev)
        torch.cuda.synchronize()
        setup[name] = time.perf_counter() - t0
    dt_shape = tuple(mm["exact"].tmap.dt.shape)
    rt = mm["default"].rtex.rt
    say("multimap", f"{len(tracks)} tracks stacked: dt {dt_shape}; "
        f"make_multimap_params (map loads, EDTs on the host, padding, stacking) exact "
        f"{setup['exact']:.2f} s; default (and {len(tracks)} textures marched on the card, "
        f"padded, stacked: rt {tuple(rt.shape)} {rt.dtype}, "
        f"{rt.numel() * rt.element_size() / 1e9:.2f} GB) {setup['default']:.2f} s; ultra "
        f"(1-channel textures, rt {tuple(mm['ultra'].rtex.rt.shape)}) {setup['ultra']:.2f} s")
    midx = (torch.arange(ENVS, device=dev) % len(tracks)).to(torch.int32)
    table = torch.as_tensor(assets.start_pose_table(tracks, AGENTS), dtype=cfg.tdtype,
                            device=dev)
    mm_march = multimap_march_phase(exact_cfg, mm["exact"], midx, dev, reports)
    multimap_mega_phase(cfg, mm["default"], tracks, midx, dev)
    maps = (midx, table)
    mm_default = main_path("multimap", cfg, mm["default"], dev, STEPS,
                           ("mega_edge_ttc[opp]",), args.profile, maps=maps)
    main_path("multimap_bilinear", bil, mm["default"], dev, STEPS,
              ("theta_shuffle_blend_edge_ttc_opp",), args.profile, maps=maps)
    main_path("multimap_ultra", ultra, mm["ultra"], dev, STEPS, ("theta_spectral_ttc",),
              args.profile, maps=maps)
    mm_exact = main_path("multimap_exact", exact_cfg, mm["exact"], dev, STEPS,
                         ("march[beams]",), args.profile, max_step_ms=MARCH_STEP_MS,
                         maps=maps)
    if mm_default["prestep"] != 0:
        fail("multimap: the state kernel ran under map_idx")

    # PPO training: the trainer's configs read the textures built above
    ppo, pstate, states, obs, ppo_k4 = ppo_phase(params, dev, args.profile)
    ppo_k5 = ppo_once("ppo_ultra", ["--ultra"], leg_params, dev, "theta_spectral_ttc")
    ppo_once("ppo_multimap_pursuit", ["--multi-map", "--opponents", "pursuit"],
             mm["default"], dev, "theta_shuffle_blend_edge_ttc_opp", after=pursuit_progress)
    checkpoint_phase(ppo, pstate, states, obs)
    ppo_policy, ppo_obs = pstate.policy, obs
    del ppo, pstate, states, obs, mm

    # the gym surface: VecF110Env, the state health checks, gym_compat
    vec_counts, vec, vec_obs = vec_env_phase(dev, args.profile)
    debug_phase(vec, vec_obs, dev)
    del vec, vec_obs
    compat_counts = gym_compat_phase(dev, args.profile)

    # the bitmap-SAC stack: the rasterizer's kernels, then the three trainers
    raster = rasterize_phase(dev, reports)
    bm_counts, _ = sac_bitmap_phase(dev, smi)
    scale_counts, _ = sac_scale_phase(dev, smi)
    sac_counts, sac_tr = sac_phase(dev, smi)

    # the tooling tier: trackgen with the device EDT, the CMA-ES search, the
    # float64 fast scan and scan_backend="xla", export, the lidar collector
    edt_load, trackgen_counts = trackgen_phase(dev, args.profile)
    edt_rec.update(edt_phase([edt_load.pop("yaml")], dev, reports))
    param_counts, _ = param_search_phase(dev)
    fast64_phase(params, dev, args.profile)
    export_phase(ppo_policy, sac_tr.sstate.actor, sac_tr.buf.obs[:4], ppo_obs, dev)
    del ppo_policy, ppo_obs, sac_tr
    collect_counts = collect_lidar_phase(dev)

    # the rest of the package: the element-gather scan, data-parallel PPO,
    # the last five examples
    trace_fast_phase(cfg, params, leg_cfg, leg_params, dev)
    dist_rec = distributed_phase(dev, args.ranks, workdir)
    prof_counts = profile_components_phase(dev)
    err_counts = scan_error_phase(dev)
    gen_counts = generalization_phase(dev)
    mpc_demo_phase(dev)
    lidar_counts = lidar_bitmap_phase(dev, os.path.join(workdir, "lidar_bitmaps"))
    # the laws of the random draws, the reset step's on the default texture
    draws_phase(dev, params)

    mega_src = {"route": "cuda", "source": "red_gym_tpu_torch/csrc/mega_edge_ttc.cu",
                "replaces": "red_gym_tpu/ops/pallas_scan.py:1027"}
    blend_src = {"route": "cuda", "source": "red_gym_tpu_torch/csrc/theta_blend.cu"}
    records = [
        {"name": "mega_edge_ttc", **mega_src,
         "launches": eager["mega_edge_ttc[plain]"], **mega["plain"]},
        {"name": "mega_edge_ttc+opp", **mega_src,
         "launches": default["mega_edge_ttc[opp]"],
         "vec_env_launches": vec_counts["mega_edge_ttc[opp]"], **mega["opp"]},
        {"name": "mega_edge_ttc+opp+pool_rot", **mega_src,
         "launches": rot["mega_edge_ttc[opp+pool_rot]"], **mega["opp+pool_rot"]},
        {"name": "prestep", "route": "cuda", "source": "red_gym_tpu_torch/csrc/prestep.cu",
         "replaces": "red_gym_tpu/ops/pallas_state.py:134",
         "launches": default["prestep"], "vec_env_launches": vec_counts["prestep"], **pre},
    ]
    for name, line, counts in (
            ("theta_shuffle_blend_edge_ttc", 461, bil_ttc),
            ("theta_shuffle_blend_edge_ttc_opp", 560, bilinear),
            ("theta_shuffle_blend_edge", 267, bil_edge),
            ("theta_shuffle_blend", 74, legacy)):
        records.append({"name": name, **blend_src,
                        "replaces": f"red_gym_tpu/ops/pallas_scan.py:{line}",
                        "launches": counts[name], **blend[name]})
    # kernel 4 on the trainer's default path, kernel 5 on --ultra
    next(r for r in records
         if r["name"] == "theta_shuffle_blend_edge_ttc_opp")["ppo_launches"] = ppo_k4
    records.append({"name": "theta_spectral_ttc", "route": "cuda",
                    "source": "red_gym_tpu_torch/csrc/theta_spectral.cu",
                    "replaces": "red_gym_tpu/ops/pallas_scan.py:692",
                    "launches": ultra_counts["theta_spectral_ttc"],
                    "ppo_launches": ppo_k5,
                    "sac_scale_launches": scale_counts["theta_spectral_ttc"], **spectral})
    records.append({"name": "march", "route": "cuda",
                    "source": "red_gym_tpu_torch/csrc/march.cu",
                    "replaces": "red_gym_tpu/ops/scan.py:153",
                    "note": "not a TPU kernel: replaces the lax.while_loop of the march",
                    "launches": exact["march[beams]"],
                    "gym_compat_launches": compat_counts["march[beams]"],
                    "sac_bitmap_launches": bm_counts["march[beams]"],
                    "sac_launches": sac_counts["march[beams]"], **march})
    records.append({"name": "march+stacked", "route": "cuda",
                    "source": "red_gym_tpu_torch/csrc/march.cu",
                    "replaces": "red_gym_tpu/ops/scan.py:153",
                    "note": "the march's stacked form (multi-map, a map index a pose row); "
                            "not a TPU kernel",
                    "launches": mm_exact["march[beams]"], **mm_march})
    for name, line in (("fill_polygon", 43), ("draw_segments", 67)):
        records.append({"name": name, "route": "cuda",
                        "source": "red_gym_tpu_torch/csrc/rasterize.cu",
                        "replaces": f"red_gym_tpu/ops/rasterize.py:{line}",
                        "note": "not a TPU kernel: replaces XLA's fused broadcast of the "
                                "rasterizer; launches on [sac_bitmap]",
                        "launches": bm_counts[name], "sac_launches": sac_counts[name],
                        **raster[name]})
    records.append({"name": "edt", "route": "cuda", "source": "red_gym_tpu_torch/csrc/edt.cu",
                    "replaces": "red_gym_tpu/ops/edt.py:34",
                    "note": "not a TPU kernel: replaces XLA's two dense min-plus passes of the "
                            "device EDT; launches on [trackgen] (one a load_map)",
                    "launches": edt_load["edt"], "maps": edt_rec,
                    **edt_rec[assets_name(assets.named_map_yaml(TRACK))]})
    next(r for r in records if r["name"] == "march").update(
        param_search_launches=param_counts["march[beams]"],
        collect_lidar_launches=collect_counts["march[beams]"])
    next(r for r in records if r["name"] == "mega_edge_ttc+opp")[
        "trackgen_launches"] = trackgen_counts["mega_edge_ttc[opp]"]
    next(r for r in records if r["name"] == "prestep")[
        "trackgen_launches"] = trackgen_counts["prestep"]
    by_name = {r["name"]: r for r in records}
    by_name["mega_edge_ttc+opp"].update(
        profile_components_launches=prof_counts["mega_edge_ttc[opp]"],
        generalization_launches=gen_counts["mega_edge_ttc[opp]"])
    by_name["prestep"]["profile_components_launches"] = prof_counts["prestep"]
    by_name["theta_shuffle_blend_edge_ttc_opp"]["distributed_launches"] = dist_rec["k4"]
    by_name["theta_shuffle_blend_edge"].update(
        profile_components_launches=prof_counts["theta_shuffle_blend_edge"],
        scan_error_launches=err_counts["theta_shuffle_blend_edge"])
    by_name["theta_shuffle_blend"]["scan_error_launches"] = err_counts["theta_shuffle_blend"]
    by_name["march"].update(profile_components_launches=prof_counts["march[beams]"],
                            scan_error_launches=err_counts["march[beams]"],
                            lidar_bitmap_launches=lidar_counts["march[beams]"])
    for name in ("fill_polygon", "draw_segments"):
        by_name[name]["lidar_bitmap_launches"] = lidar_counts[name]
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
