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
   the range texture is marched on the card;
4. kernel phases at K = 16384 envs x 2 agents, each kernel against its
   plain PyTorch twin on the card, with median CUDA-event times of both:
   - mega_edge_ttc, plain, on operands made by the main path's own prep
     from random free poses;
   - mega_edge_ttc with opponents (slab noise), and with opponents and the
     pool_rot resident pool (offset rows - 37), the second car of each env
     placed within 2.5 m of the first; some beams must be shortened;
   - the scan bar: p99 |diff| < 1e-3 m, < 0.2 % of beams off by more than
     4 texture cells, iTTC hits equal;
   - prestep (the pre-scan state kernel) on random in-range states and
     actions: texture row, steer_cnt, i_f and inb exactly equal, float
     outputs within 1e-6 (bit-exactness is reported);
   - the four epilogue kernels of the unfused scan (theta_shuffle_blend
     and its edge, edge + iTTC and edge + iTTC + opponent forms) on the
     rolled spectra of the bilinear config's prep chain, cars within 2.5 m
     of each other; the scan bar (hits where a kernel has them); the
     opponent form must shorten some beams;
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
     and the eager tail.

``--profile`` adds torch.profiler summaries (device kernels and device
busy time per step) of the default, eager and bilinear paths, and tables of
the default and the bilinear path's kernels by device time.

The last two lines are the kernels' JSON record and ``{"ok": true, ...}``.
"""

from __future__ import annotations

import argparse
import dataclasses
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
PRESTEP_TOL = 1e-6                   # prestep float outputs, kernel vs twin
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
    far = float((err > 4 * cell).float().mean())
    max_err = float(err.max())
    hits = ""
    if hit_r is not None:
        n_hits = int(hit_r.sum())
        hit_diff = int((hit_k != hit_r).sum())
        hits = f", {n_hits} hit rows, {hit_diff} hit mismatches"
    say("kernel", f"{label}: K={out_k.shape[0]} B={out_k.shape[1]}: p99 |diff| "
        f"{p99:.3e} m, max {max_err:.3e} m, {100 * far:.4f}% beams > 4 cells{hits}")
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


def timed(label: str, kernel, plain) -> dict:
    ms = median_ms(kernel, TIMING_REPS)
    plain_ms = median_ms(plain, TIMING_REPS)
    say("kernel", f"{label}: median of {TIMING_REPS}: CUDA kernel {ms:.3f} ms, "
        f"plain PyTorch twin {plain_ms:.3f} ms")
    return {"ms": ms, "plain_ms": plain_ms}


def mega_phase(cfg, params, dev) -> dict:
    """The megakernel's plain, opp and opp+pool_rot variants against the
    twin; {variant: record fields}."""
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
                     **timed("plain", lambda: mega(**ops), lambda: ref(**ops))}}

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
                     **timed(name, lambda: mega(**ops), lambda: ref(**ops))}
    return rec


def blend_phase(cfg, params, dev) -> dict:
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
        rec[name] = {"max_abs_err": err, **timed(name, lambda: kernel(**kw),
                                                  lambda: twin(**kw))}
    return rec


def prestep_phase(cfg, params, dev) -> dict:
    """The state kernel against its eager twin on random in-range states."""
    import torch

    from red_gym_tpu_torch.ops import state_kernels

    gen = torch.Generator(device=dev).manual_seed(2)
    args = random_states(params, (ENVS, AGENTS), gen)
    got = state_kernels.prestep(cfg, params, *args)
    want = state_kernels.prestep_reference(cfg, params, *args)
    torch.cuda.synchronize()
    names = ("x", "steer_buf", "steer_cnt", "rows", "scal")
    exact = {n: bool(torch.equal(g, w)) for n, g, w in zip(names, got, want)}
    max_err = max(float((g.float() - w.float()).abs().max())
                  for n, g, w in zip(names, got, want))
    ints = dict(rows=(got[3], want[3]), steer_cnt=(got[2], want[2]),
                i_f=(got[4][..., 3], want[4][..., 3]), inb=(got[4][..., 4], want[4][..., 4]))
    n_diff = {n: int((g != w).sum()) for n, (g, w) in ints.items()}
    say("kernel", f"prestep: K={ENVS * AGENTS}: max |diff| {max_err:.3e}; bit-exact "
        f"{exact}; integer mismatches {n_diff}")
    if any(n_diff.values()):
        fail(f"prestep: integer outputs differ from the twin: {n_diff}")
    if not max_err <= PRESTEP_TOL:
        fail(f"prestep: float outputs differ from the twin by {max_err}")
    return {"max_abs_err": max_err,
            **timed("prestep", lambda: state_kernels.prestep(cfg, params, *args),
                    lambda: state_kernels.prestep_reference(cfg, params, *args))}


def launch_counts() -> dict:
    from red_gym_tpu_torch.ops import blend_kernels, scan_kernels, state_kernels

    return {**{f"mega_edge_ttc[{k}]": v
               for k, v in scan_kernels.mega_edge_ttc.launches.items()},
            "prestep": state_kernels.prestep.launches,
            **{fn.__name__: fn.launches for fn in blend_kernels.KERNELS}}


def reset_launch_counts() -> None:
    from red_gym_tpu_torch.ops import blend_kernels, scan_kernels, state_kernels

    scan_kernels.reset_launches()
    state_kernels.prestep.launches = 0
    blend_kernels.reset_launches()


def main_path(label: str, cfg, params, dev, steps: int, uses: tuple,
              profile: bool) -> dict:
    """Drive one path; ``uses`` names the launch counters it must advance
    (once per step and reset step); every other counter must stay 0."""
    import torch

    from red_gym_tpu_torch import assets, rollout

    start = torch.as_tensor(assets.waypoint_start_poses(TRACK, AGENTS),
                            dtype=cfg.tdtype, device=dev)
    poses = start.expand(ENVS, AGENTS, 3).contiguous()
    gen = torch.Generator(device=dev).manual_seed(1)
    policy = rollout.random_policy(cfg)
    state, obs, *_ = rollout.batched_reset(cfg, params, poses, gen)
    carry = rollout.RolloutCarry(state, obs)
    carry, _ = rollout.make_rollout(cfg, params, policy, WARMUP_STEPS)(carry, gen)
    if profile:
        profile_steps(label, cfg, params, policy, carry, gen,
                      table=label in ("default", "bilinear"))
    run = rollout.make_rollout(cfg, params, policy, steps)
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
    for name, n in counts.items():
        want = steps + resets if name in uses else 0
        if n != want:
            fail(f"{label}: {name} launched {n} times, expected {want} "
                 f"({steps} steps + {resets} resets)" if want else
                 f"{label}: {name} launched {n} times on a path that does not run it")
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
    return counts


def profile_steps(label, cfg, params, policy, carry, gen, table: bool) -> None:
    """Device kernels and device busy time per step over 5 steps
    (torch.profiler), and with ``table`` the kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from red_gym_tpu_torch import rollout

    n = 5
    run = rollout.make_rollout(cfg, params, policy, n)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, outs = run(carry, gen)
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3
    say(f"profile:{label}", f"{n} steps ({outs['resets']} reset steps): "
        f"{len(dev_events)} device ops ({len(dev_events) / n:.0f} per step), "
        f"device busy {busy_ms:.2f} ms ({busy_ms / n:.2f} ms per step)")
    if table:
        for line in prof.key_averages().table(sort_by="cuda_time_total",
                                              row_limit=25).splitlines():
            print(f"[profile] {line}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile 5 steps of the default, eager and bilinear paths")
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
    libs = _build.build_all()
    for name, lib in libs.items():
        with open(lib + ".log") as f:
            report = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
        say("build", f"{name} -> {os.path.relpath(lib)}; " + " | ".join(report))
    say("build", f"nvcc build of {len(libs)} kernel(s), in parallel: "
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

    # the bilinear config (bench.py's "bilinear" mode) reads the same
    # texture: its channels do not depend on rt_spatial
    bil = dataclasses.replace(cfg, rt_spatial="bilinear")
    mega = mega_phase(cfg, params, dev)
    pre = prestep_phase(cfg, params, dev)
    blend = blend_phase(bil, params, dev)

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
    # bench.py's "legacy" mode: occlusion off, no grad channels, so a
    # 1-channel texture of its own, marched on the card
    leg_cfg = dataclasses.replace(bil, rt_occlusion="off", rt_grad=False)
    t0 = time.perf_counter()
    leg_params = env.make_params(leg_cfg, assets.named_map_yaml(TRACK), device=dev)
    torch.cuda.synchronize()
    say("texture", f"legacy: rt {tuple(leg_params.rtex.rt.shape)}; make_params "
        f"{time.perf_counter() - t0:.1f} s")
    legacy = main_path("legacy", leg_cfg, leg_params, dev, STEPS,
                       ("theta_shuffle_blend",), False)

    mega_src = {"route": "cuda", "source": "red_gym_tpu_torch/csrc/mega_edge_ttc.cu",
                "replaces": "red_gym_tpu/ops/pallas_scan.py:1027"}
    blend_src = {"route": "cuda", "source": "red_gym_tpu_torch/csrc/theta_blend.cu"}
    records = [
        {"name": "mega_edge_ttc", **mega_src,
         "launches": eager["mega_edge_ttc[plain]"], **mega["plain"]},
        {"name": "mega_edge_ttc+opp", **mega_src,
         "launches": default["mega_edge_ttc[opp]"], **mega["opp"]},
        {"name": "mega_edge_ttc+opp+pool_rot", **mega_src,
         "launches": rot["mega_edge_ttc[opp+pool_rot]"], **mega["opp+pool_rot"]},
        {"name": "prestep", "route": "cuda", "source": "red_gym_tpu_torch/csrc/prestep.cu",
         "replaces": "red_gym_tpu/ops/pallas_state.py:134",
         "launches": default["prestep"], **pre},
    ]
    for name, line, counts in (
            ("theta_shuffle_blend_edge_ttc", 461, bil_ttc),
            ("theta_shuffle_blend_edge_ttc_opp", 560, bilinear),
            ("theta_shuffle_blend_edge", 267, bil_edge),
            ("theta_shuffle_blend", 74, legacy)):
        records.append({"name": name, **blend_src,
                        "replaces": f"red_gym_tpu/ops/pallas_scan.py:{line}",
                        "launches": counts[name], **blend[name]})
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
