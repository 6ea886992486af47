#!/usr/bin/env python3
"""Same-card A/B of one of the port's kernels between another checkout of
this repository and this one, on an NVIDIA GPU: the pre-scan state kernel
(``--kernel prestep``, the default), the exact scan's march
(``--kernel march``), the rasterizer's fill and segment draw
(``--kernel raster``) or the device EDT (``--kernel edt``).

    python3 prestep_ab.py OTHER [--kernel prestep|march|raster|edt] [--json PATH]

``OTHER`` is a checkout of another commit, for example the parent's
``git archive`` unpacked under ``_checkout/``.  Each checkout runs in a
subprocess of its own, with its own ``red_gym_tpu_torch`` (its kernels built
from its sources), in turns OTHER, this, this, OTHER.  Each run reports,
through the functions of this tree's ``chip_smoke.py``:

``--kernel prestep``, at K = 16384 x 2 rows of the default config
(track_0019, float32) on two input sets: ``random``
(``chip_smoke.random_states``, about a quarter of the cars in the kinematic
branch) and ``rollout`` (the cars of the default path after 10 steps of the
random policy):

- ``equal``: all five outputs of ``state_kernels.prestep`` ``torch.equal``
  to ``prestep_reference``, for RK4 and Euler;
- ``device_ms``: the kernel's own time on the card a call
  (``chip_smoke.device_ms``: the profiler's median over 60 launches);
- ``launch``: the grid, block and registers of the kernel, from the
  profiler's trace;
- ``host_us``: the host time of one ``state_kernels.prestep`` call and
  ``section_us`` that of ``env.sim_step`` from its start to the return of
  its state-kernel call, where the step is cut short (the scope check, the
  pack and the call), both by ``chip_smoke.host_us`` (200 calls behind
  ``torch.cuda._sleep``);

then ``floor_ms``: the device time of an empty kernel launched with each
checkout's grid and block.

``--kernel march``, float32, on four operands of ``march_kernels.
march_beams``: ``full``, 16384 x 2 cars x 1080 beams on random free poses
of track_0019 (``chip_smoke.march_phase``'s); ``stacked``, the same on the
11 packaged tracks, env e on track e % 11 (``multimap_march_phase``'s);
``gym_compat``, one env's 2 x 1080 rays; ``param_search``, the CMA-ES
race's 50 x 64 rays:

- ``equal``: the kernel ``torch.equal`` to ``march_beams_reference`` on
  each, and with ``march_iters=40`` at full width;
- ``device_ms`` (as above) and ``window_ms`` (``chip_smoke.median_ms``:
  the median CUDA-event window of back-to-back calls);
- ``launch``: grid, block and registers from the profiler's trace;
- ``env_steps_per_s`` of the ``exact`` and ``multimap_exact`` main paths
  (``chip_smoke.main_path``, 200 steps after 10 warm-up steps).

``--kernel raster``, on the 600 endpoints of the exact scan's scans at
random free poses of track_0019 (``chip_smoke.raster_points``), each
operand a call of ``raster_kernels.fill_polygon`` or ``draw_segments``:
``fill`` and ``outline`` (FILL's fill and closed outline) and ``rays``
(RAYS' segments from the centre) at 64 x 256 x 256; the same three at
``one`` image of 256 x 256 and at ``small``, 4 images of 128 x 96:

- ``equal``: the kernel ``torch.equal`` to its twin (``fill_polygon_reference``
  or ``draw_segments_reference`` on a zero canvas);
- ``device_ms``, ``window_ms`` and ``launch`` of each, as above.

``--kernel edt``, each operand one ``edt_kernels.edt_transform`` call (kernel
E: a row kernel, then a column kernel): ``track_0019``; ``stack``, track_0019
zero-padded to the largest height and width of the packaged maps (the
multi-map stack's 952 x 947); ``track_wide`` (the largest distances of the
packaged tracks); ``berlin``; and the long-search grids of
``chip_smoke.edt_long_searches`` at resolution 1: ``hall_2048`` (walls only
on the border), ``one_zero_2048`` (one zero pixel at (0, 0)) and
``free_1024`` (all free):

- ``equal``: the kernel ``torch.equal`` to ``edt_reference``;
- ``device_ms``: each kernel's own time and their sum (``total``), as above;
- ``window_ms`` as above, and ``launch``: grid, block and registers of each
  of the two kernels.

The last line is one JSON object with every number; ``--json`` also writes
it to a file.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
# the device kernel of each A/B, by a part of its name both checkouts share
DEVICE_NAME = {"prestep": "prestep_kernel", "march": "march_beams",
               "fill": "fill_polygon_kernel", "draw": "draw_segments_kernel"}
EMPTY_SRC = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


class _Stop(Exception):
    """Cuts env.sim_step short after its state-kernel call."""


def launch_shape(fn, out_dir: str, cs, kernel: str) -> dict:
    """Grid, block and registers of the device kernel named ``kernel``
    that ``fn`` launches, from the kernel record of a torch.profiler
    trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(out_dir, f"trace-{os.getpid()}.json")
    for _ in range(cs.DEVICE_WINDOWS):  # the profiler drops a kernel record now and then
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        os.remove(path)
        for e in events:
            if e.get("cat") == "kernel" and kernel in e.get("name", ""):
                a = e["args"]
                return {"grid": a["grid"], "block": a["block"],
                        "regs": a.get("registers per thread")}
    cs.fail(f"no {kernel} record in {cs.DEVICE_WINDOWS} profiler traces")


def this_chip_smoke(root: str):
    """This tree's chip_smoke.py, in either run, with the checkout at
    ``root`` first on the path, so its functions import that checkout's
    package."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path[:0] = [root]
    return cs


def measure_prestep(root: str) -> dict:
    """Every number of the state kernel's A/B of the checkout at ``root``,
    with its own package."""
    import dataclasses

    cs = this_chip_smoke(root)
    import torch

    from red_gym_tpu_torch import assets, env, rollout
    from red_gym_tpu_torch.config import Integrator, SimConfig
    from red_gym_tpu_torch.ops import _build, state_kernels

    if not os.path.abspath(state_kernels.__file__).startswith(os.path.abspath(root)):
        cs.fail(f"imported {state_kernels.__file__}, not the one under {root}")
    dev = torch.device("cuda", 0)
    os.environ["RED_GYM_TPU_TEXTURE_CACHE"] = "off"
    cfg = SimConfig(num_agents=cs.AGENTS, num_beams=cs.BEAMS, scan_mode="fast")
    params = env.make_params(cfg, assets.named_map_yaml(cs.TRACK), device=dev)
    pack = state_kernels.pack_params(params.vehicle, params.tmap, params.rtex)
    gen = torch.Generator(device=dev).manual_seed(2)
    sets = {"random": cs.random_states(params, (cs.ENVS, cs.AGENTS), gen)}
    start = torch.as_tensor(assets.waypoint_start_poses(cs.TRACK, cs.AGENTS),
                            dtype=cfg.tdtype, device=dev)
    policy = rollout.random_policy(cfg)
    state, obs, *_ = rollout.batched_reset(
        cfg, params, start.expand(cs.ENVS, cs.AGENTS, 3).contiguous(), gen)
    carry, _ = rollout.make_rollout(cfg, params, policy, 10)(
        rollout.RolloutCarry(state, obs), gen)
    state, act = carry.state, policy(carry.obs, gen)
    sets["rollout"] = (state.x, state.steer_buf, state.steer_cnt, act)

    res = {"equal": {}, "device_ms": {}}
    for name, args in sets.items():
        for integ in (Integrator.RK4, Integrator.EULER):
            c = dataclasses.replace(cfg, integrator=integ)
            got = state_kernels.prestep(c, params, *args, pack)
            want = state_kernels.prestep_reference(c, params, *args)
            res["equal"][f"{name}/{integ.name}"] = all(
                bool(torch.equal(g, w)) for g, w in zip(got, want))
        res["device_ms"][name] = cs.device_ms(
            lambda args=args: state_kernels.prestep(cfg, params, *args, pack),
            (DEVICE_NAME["prestep"],))["total"]
    args = sets["random"]

    def call():
        state_kernels.prestep(cfg, params, *args, pack)

    res["launch"] = launch_shape(call, _build.BUILD_DIR, cs, DEVICE_NAME["prestep"])
    res["host_us"] = cs.host_us(call)

    prestep = state_kernels.prestep

    def stop_after(*a):
        prestep(*a)
        raise _Stop

    stop_after.launches = prestep.launches  # prestep counts through its name

    def section():
        try:
            env.sim_step(cfg, params, state, act, gen)
        except _Stop:
            return
        cs.fail("env.sim_step did not call state_kernels.prestep")

    state_kernels.prestep = stop_after
    res["section_us"] = cs.host_us(section)
    state_kernels.prestep = prestep
    return res


def measure_march(root: str) -> dict:
    """Every number of the march's A/B of the checkout at ``root``, with
    its own package."""
    import dataclasses

    cs = this_chip_smoke(root)
    import torch

    from red_gym_tpu_torch import assets, env
    from red_gym_tpu_torch.config import SimConfig
    from red_gym_tpu_torch.ops import _build, march_kernels as mk

    if not os.path.abspath(mk.__file__).startswith(os.path.abspath(root)):
        cs.fail(f"imported {mk.__file__}, not the one under {root}")
    dev = torch.device("cuda", 0)
    cfg = SimConfig(num_agents=cs.AGENTS, num_beams=cs.BEAMS)
    params = env.make_params(cfg, assets.named_map_yaml(cs.TRACK), device=dev)
    tracks = assets.packaged_tracks()
    mm = env.make_multimap_params(cfg, tracks, device=dev)
    midx = (torch.arange(cs.ENVS, device=dev) % len(tracks)).to(torch.int32)
    raws = [cs.map_of_stack(mm.tmap, m, unpad=True) for m in range(len(tracks))]
    gen = torch.Generator(device=dev).manual_seed(9)
    full = cs.map_free_poses(params.tmap, cs.ENVS * cs.AGENTS, gen).reshape(
        cs.ENVS, cs.AGENTS, 3)
    gen = torch.Generator(device=dev).manual_seed(11)
    stacked = cs.per_map_poses(lambda m, n: cs.map_free_poses(raws[m], n * cs.AGENTS, gen)
                               .reshape(n, cs.AGENTS, 3), midx, cs.AGENTS)
    rows = midx[:, None].expand(cs.ENVS, cs.AGENTS).contiguous()
    gen = torch.Generator(device=dev).manual_seed(12)
    one = cs.map_free_poses(params.tmap, cs.AGENTS, gen).reshape(1, cs.AGENTS, 3)
    race = cs.map_free_poses(params.tmap, 50, gen).reshape(50, 1, 3)
    race_cfg = dataclasses.replace(cfg, num_beams=64)
    it_cfg = dataclasses.replace(cfg, march_iters=40)
    operands = {  # (poses, params, cfg, map index)
        "full": (full, params, cfg, None), "full_iters40": (full, params, it_cfg, None),
        "stacked": (stacked, mm, cfg, rows), "gym_compat": (one, params, cfg, None),
        "param_search": (race, params, race_cfg, None)}
    res = {"equal": {}, "device_ms": {}, "window_ms": {}}
    for name, (poses, p, c, mi) in operands.items():
        def kernel(poses=poses, p=p, c=c, mi=mi):
            return mk.march_beams(poses, p.tables.cosines, p.tables.sines, p.tmap, c, mi)

        res["equal"][name] = bool(torch.equal(kernel(), mk.march_beams_reference(
            poses, p.tables.cosines, p.tables.sines, p.tmap, c, mi)))
        if name == "full_iters40":
            continue
        res["device_ms"][name] = cs.device_ms(kernel, (DEVICE_NAME["march"],))["total"]
        res["window_ms"][name] = cs.median_ms(kernel, cs.TIMING_REPS)
        if name == "full":
            res["launch"] = launch_shape(kernel, _build.BUILD_DIR, cs, DEVICE_NAME["march"])
    table = torch.as_tensor(assets.start_pose_table(tracks, cs.AGENTS), dtype=cfg.tdtype,
                            device=dev)
    res["env_steps_per_s"] = {}
    for label, p, maps in (("exact", params, None), ("multimap_exact", mm, (midx, table))):
        out = {}
        cs.main_path(label, cfg, p, dev, cs.STEPS, ("march[beams]",), False,
                     max_step_ms=cs.MARCH_STEP_MS, maps=maps, out=out)
        res["env_steps_per_s"][label] = out["env_steps_per_s"]
    return res


def measure_raster(root: str) -> dict:
    """Every number of the rasterizer's A/B of the checkout at ``root``,
    with its own package."""
    cs = this_chip_smoke(root)
    import torch

    from red_gym_tpu_torch.ops import _build, raster_kernels as rk, rasterize

    if not os.path.abspath(rk.__file__).startswith(os.path.abspath(root)):
        cs.fail(f"imported {rk.__file__}, not the one under {root}")
    dev = torch.device("cuda", 0)
    scans, pts = cs.raster_points(dev)
    small = rasterize.beam_endpoints(scans[:4], 600, (128, 96), 10.0)
    t = rk.segment_t(dev)
    res = {"equal": {}, "device_ms": {}, "window_ms": {}, "launch": {}}
    for shape, p, dims in (("", pts, (256, 256)), ("one/", pts[:1], (256, 256)),
                           ("small/", small, (128, 96))):
        center = torch.tensor([dims[0] // 2, dims[1] // 2], dtype=torch.int32,
                              device=dev).expand_as(p)
        canvas = torch.zeros((p.shape[0], *dims), dtype=torch.uint8, device=dev)
        ops = {"fill": ("fill", lambda p=p, dims=dims: rk.fill_polygon(p, dims),
                        lambda p=p, dims=dims: rk.fill_polygon_reference(p, dims))}
        for label, starts, ends in (("outline", p, torch.roll(p, -1, dims=-2)),
                                    ("rays", center, p)):
            ops[label] = ("draw",
                          lambda s=starts, e=ends, c=canvas: rk.draw_segments(c, s, e, t),
                          lambda s=starts, e=ends, c=canvas: rk.draw_segments_reference(
                              torch.zeros_like(c), s, e, t))
        for label, (kind, kernel, twin) in ops.items():
            name = shape + label
            if kind == "draw":
                canvas.zero_()
            res["equal"][name] = bool(torch.equal(kernel(), twin()))
            res["device_ms"][name] = cs.device_ms(kernel, (DEVICE_NAME[kind],))["total"]
            res["window_ms"][name] = cs.median_ms(kernel, cs.TIMING_REPS)
            res["launch"][name] = launch_shape(kernel, _build.BUILD_DIR, cs, DEVICE_NAME[kind])
    return res


def measure_edt(root: str) -> dict:
    """Every number of kernel E's A/B of the checkout at ``root``, with its
    own package."""
    cs = this_chip_smoke(root)
    import torch

    from red_gym_tpu_torch import assets
    from red_gym_tpu_torch.ops import _build, edt_kernels as ek

    if not os.path.abspath(ek.__file__).startswith(os.path.abspath(root)):
        cs.fail(f"imported {ek.__file__}, not the one under {root}")
    dev = torch.device("cuda", 0)

    def grid(path, pad=None):
        return cs.edt_grid(path, dev, pad)[1:]

    track = assets.named_map_yaml(cs.TRACK)
    operands = {"track_0019": grid(track), "stack": grid(track, cs.edt_stack_size(cs.edt_maps())),
                "track_wide": grid(assets.named_map_yaml("track_wide")),
                "berlin": grid(os.path.join(assets.DATA_DIR, "classic", "berlin.yaml"))}
    operands.update({n: (o, 1.0) for n, o in cs.edt_long_searches(dev).items()})
    res = {"equal": {}, "device_ms": {}, "window_ms": {}, "launch": {}}
    for name, (o, r) in operands.items():
        def kernel(o=o, r=r):
            return ek.edt_transform(o, r)

        res["equal"][name] = bool(torch.equal(kernel(), ek.edt_reference(o, r)))
        res["device_ms"][name] = cs.device_ms(kernel, cs.EDT_KERNELS)
        res["window_ms"][name] = cs.median_ms(kernel, cs.TIMING_REPS)
        res["launch"][name] = {k: launch_shape(kernel, _build.BUILD_DIR, cs, k)
                               for k in cs.EDT_KERNELS}
    return res


MEASURE = {"prestep": measure_prestep, "march": measure_march, "raster": measure_raster,
           "edt": measure_edt}


def floors(shapes: dict, cs) -> dict:
    """{checkout: device ms of an empty kernel of its grid and block}."""
    import torch

    from red_gym_tpu_torch.ops import _build

    out_dir = os.path.join(_build.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    src, lib = os.path.join(out_dir, "empty.cu"), os.path.join(out_dir, "empty.so")
    with open(src, "w") as f:
        f.write(EMPTY_SRC)
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        cs.fail(f"nvcc failed on the empty kernel:\n{proc.stdout}{proc.stderr}")
    empty = ctypes.CDLL(lib)
    empty.empty_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    stream = torch.cuda.current_stream(0).cuda_stream
    out = {}
    for name, s in shapes.items():
        blocks, threads = s["grid"][0], s["block"][0]
        if s["grid"][1:] != [1, 1] or s["block"][1:] != [1, 1]:
            cs.fail(f"{name}: a grid or block of more than one dimension: {s}")
        out[name] = cs.device_ms(lambda b=blocks, t=threads: empty.empty_launch(b, t, stream),
                                 ("empty_kernel",))["total"]
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="checkout of the commit to compare with")
    ap.add_argument("--kernel", choices=sorted(MEASURE), default="prestep",
                    help="the kernel to compare (default: prestep)")
    ap.add_argument("--json", metavar="PATH", help="also write the result to this file")
    ap.add_argument("--one", metavar="ROOT", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.one:
        print(json.dumps(MEASURE[a.kernel](a.one)), flush=True)
        return
    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this A/B needs a GPU")
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    roots = {"other": os.path.abspath(a.other), "this": ROOT}
    runs = {n: [] for n in roots}
    for n in ("other", "this", "this", "other"):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), a.other,
                               "--kernel", a.kernel, "--one", roots[n]],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            cs.fail(f"the run of {roots[n]} failed:\n{proc.stdout}\n{proc.stderr}")
        runs[n].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        cs.say("ab", f"{n}: {runs[n][-1]}")
    result = {"card": smi, "kernel": a.kernel, "K": cs.ENVS * cs.AGENTS, "runs": runs}
    if a.kernel == "prestep":
        result["floor_ms"] = floors({n: r[0]["launch"] for n, r in runs.items()}, cs)
        cs.say("ab", f"floor ms: {result['floor_ms']}")
    if a.json:
        os.makedirs(os.path.dirname(os.path.abspath(a.json)), exist_ok=True)
        with open(a.json, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
