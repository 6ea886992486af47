"""CUDA-only checks of the port (marker ``cuda``); they skip without a GPU.

This file imports no JAX, so it also runs on a GPU machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

It covers what chip_smoke.py does not: every storage variant of the scan
megakernel (bfloat16 / float32 texture, bfloat16 pool / float32 fresh
noise, bfloat16 / float32 e/w taps), its opponent and pool_rot variants for
2 and 4 agents, its spectra kernel alone against its twin, row and beam
counts around the tiles of its two kernels and the blocks a SM each
instance holds, the state kernel (also with a replaced vehicle), the
epilogue kernels and the spectral render kernel against their twins, the
edge epilogues (csrc/edge_render.cuh, the megakernel's render) and kernels
5 and 7 (csrc/rowtile_gemm.cuh) at row and beam counts around their tiles
(and at B = 1081, their 4-byte-copy paths), refused launches and wrong
dtypes, and whole env steps on the GPU (default, unfused and spectral
modes) against the same steps on the CPU.  The march kernel of the exact
scan (csrc/march.cu) is held bit-equal to its twin in both entry forms,
float32 and float64, march_iters 0 and 40, at ray counts around a warp and
its block (the stacked form too),
from origins outside the map, and through a texture build; an exact-mode
F110Env step on the GPU is held against the same step on the CPU.
Multi-map batches: the march kernel's stacked form (map indices 0 to
M - 1, rays leaving their map) bit-equal to its twin and to each map marched
alone, the megakernel on a stacked texture at the scan bar and equal to
each map alone, and multi-map resets and steps on the GPU against the CPU
in the default, bilinear, ultra and exact modes.  ``vec_env.VecF110Env`` in
the library-default fast scan: the megakernel with opponents and the state
kernel launched once a step and once a reset step, and every output
torch.equal to a hand loop of ``env.step`` + ``rollout.reset_done``.  The
rasterizer's fill and segment draw (csrc/rasterize.cu) torch.equal to
their twins on fuzzed scans and on edge cases: a zigzag polygon whose
edges span the canvas, one-pixel segments (on the canvas and far off it,
on three images and on one), segments off the canvas, K = 1, 2, 12,288 and
20,000, canvases of 128 x 96, 257 x 129, 520 x 520, 1 x (2^22 + 96) (the
draw's integer form), 4 x 20000 (three of the fill's column tiles) and 2 x
(2^24 + 4000) (pixel indices that float32 rounds), one image, a mask
already holding 1s, and t tables of 1000 and 430 samples.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from chip_smoke import (close_poses, edt_long_searches, launch_counts, map_free_poses,
                        map_of_stack, params_of_stack, per_map_poses, random_free_poses,
                        random_states, reset_launch_counts, to_cpu, vec_hand_loop)
from red_gym_tpu_torch import assets, env, rollout, vec_env
from red_gym_tpu_torch.config import Integrator, SimConfig
from red_gym_tpu_torch.maps.loader import load_map, stack_maps
from red_gym_tpu_torch.ops import agent_scan, collision, march_kernels, scan
from red_gym_tpu_torch.ops import scan_fast, scan_kernels, state_kernels

pytestmark = pytest.mark.cuda
TRACK = "track_0019"


@pytest.fixture(scope="module")
def gpu_params():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = SimConfig(num_agents=2, num_beams=1080, scan_mode="fast",
                    rt_pose_stride=8, ttc_thresh=0.5)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RED_GYM_TPU_TEXTURE_CACHE", "off")
        params = env.make_params(cfg, assets.named_map_yaml(TRACK),
                                 device=torch.device("cuda"))
    return cfg, params


def _operands(cfg, params, e_n, noise_dtype, seed=0):
    dev = params.rtex.rt.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    poses = random_free_poses(params, e_n * 2, gen).reshape(e_n, 2, 3)
    vel = -2.0 + 10.0 * torch.rand((e_n, 2), generator=gen, device=dev)
    noise = (0.01 * torch.randn((e_n, cfg.num_beams), generator=gen,
                                device=dev)).to(noise_dtype)
    return scan_fast.mega_operands(poses, params.tables, params.tmap,
                                   params.rtex, cfg, noise, vel)


def _check_against_twin(params, ops, variant):
    before = scan_kernels.mega_edge_ttc.launches[variant]
    out, hit = scan_kernels.mega_edge_ttc(**ops)
    assert scan_kernels.mega_edge_ttc.launches[variant] == before + 1
    ref_out, ref_hit = scan_kernels.mega_edge_ttc_reference(**ops)
    torch.cuda.synchronize()
    err = (out - ref_out).abs()
    cell = float(params.rtex.cell)
    assert torch.isfinite(out).all()
    assert float(torch.quantile(err.flatten(), 0.99)) < 1e-3
    assert float((err > 4 * cell).float().mean()) < 2e-3
    assert torch.equal(hit, ref_hit)
    assert hit.sum() > 0, "fixture guard: no iTTC hits"
    return out


@pytest.mark.parametrize("rt_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("noise_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("ew_dtype", [torch.bfloat16, torch.float32])
def test_kernel_variants_match_plain_twin(gpu_params, rt_dtype, noise_dtype,
                                          ew_dtype):
    cfg, params = gpu_params
    ops = _operands(cfg, params, 1001, noise_dtype)   # 2002 rows: partial block
    ops.update(rt=ops["rt"].to(rt_dtype), ew_dtype=ew_dtype)
    _check_against_twin(params, ops, "plain")


@pytest.mark.parametrize("agents", [2, 4])
@pytest.mark.parametrize("variant", ["opp", "pool_rot", "opp+pool_rot"])
def test_mega_variants_match_plain_twin(gpu_params, agents, variant):
    """Opponents within 2.5 m, the pool at offset rows - 37; 1001 envs leave
    a partial last block for both agent counts."""
    cfg, params = gpu_params
    dev = params.rtex.rt.device
    gen = torch.Generator(device=dev).manual_seed(3)
    e_n = 1001
    poses = close_poses(params, e_n, agents, gen)
    vel = -2.0 + 10.0 * torch.rand((e_n, agents), generator=gen, device=dev)
    opp = pool_off = None
    noise = params.noise_pool[torch.randint(0, cfg.noise_pool_rows, (e_n,),
                                            generator=gen, device=dev)]
    if "opp" in variant:
        verts = collision.get_vertices(poses, params.vehicle.length, params.vehicle.width)
        opp = agent_scan.opponent_slab_scalars(poses, verts, params.tables)
    if "pool_rot" in variant:
        noise = params.noise_pool
        pool_off = torch.tensor([cfg.noise_pool_rows - 37], dtype=torch.int32, device=dev)
    ops = scan_fast.mega_operands(poses, params.tables, params.tmap, params.rtex,
                                  cfg, noise, vel, opp=opp, pool_off=pool_off)
    out = _check_against_twin(params, ops, variant)
    if opp is not None:
        base, _ = scan_kernels.mega_edge_ttc_reference(**{**ops, "opp": None,
                                                          "sines": None})
        assert (out < base - 1e-6).any(), "fixture guard: no beam shortened"


def _prestep_bit_equal(cfg, params, args, pack=None):
    """The state kernel's five outputs torch.equal to its twin's."""
    pack = pack if pack is not None else state_kernels.pack_params(
        params.vehicle, params.tmap, params.rtex)
    before = state_kernels.prestep.launches
    got = state_kernels.prestep(cfg, params, *args, pack)
    assert state_kernels.prestep.launches == before + 1
    want = state_kernels.prestep_reference(cfg, params, *args)
    torch.cuda.synchronize()
    for name, g, w in zip(("x", "steer_buf", "steer_cnt", "rows", "scal"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.equal(g, w), (name, float((g.float() - w.float()).abs().max()))
    return got


@pytest.mark.parametrize("integrator", [Integrator.RK4, Integrator.EULER])
def test_prestep_matches_plain_twin(gpu_params, integrator):
    """1001 x 2 random in-range cars: all five outputs bit-equal."""
    cfg, params = gpu_params
    cfg = dataclasses.replace(cfg, integrator=integrator)
    gen = torch.Generator(device=params.rtex.rt.device).manual_seed(4)
    _prestep_bit_equal(cfg, params, random_states(params, (1001, 2), gen))


# The state kernel deals 32 rows, a row a lane, to the warps of one block:
# row counts around one and two blocks, a ragged last block, and the main
# path's 16384 x 2.
PRESTEP_ROWS = 32
PRESTEP_KS = (1, PRESTEP_ROWS - 1, PRESTEP_ROWS, PRESTEP_ROWS + 1, 2 * PRESTEP_ROWS - 1,
              2 * PRESTEP_ROWS, 2 * PRESTEP_ROWS + 1, 3 * PRESTEP_ROWS + 1, 16384 * 2)


@pytest.mark.parametrize("integrator", [Integrator.RK4, Integrator.EULER])
@pytest.mark.parametrize("k_n", PRESTEP_KS)
def test_prestep_block_edges_bit_equal(gpu_params, k_n, integrator):
    cfg, params = gpu_params
    cfg = dataclasses.replace(cfg, integrator=integrator)
    gen = torch.Generator(device=params.rtex.rt.device).manual_seed(k_n)
    shape = (k_n // 2, 2) if k_n % 2 == 0 else (k_n, 1)
    _prestep_bit_equal(cfg, params, random_states(params, shape, gen))


@pytest.mark.parametrize("integrator", [Integrator.RK4, Integrator.EULER])
def test_prestep_branches_within_a_warp(gpu_params, integrator):
    """Rows of one warp on both sides of |v| = 0.5 (the kinematic and the
    dynamic branch), at exactly +-0.5, at 0, and just below 0.5 with the
    speed command far above, so that a row changes branch between the RK4
    stages; beside them warps of one branch only.  Bit-equal."""
    cfg, params = gpu_params
    cfg = dataclasses.replace(cfg, integrator=integrator)
    dev = params.rtex.rt.device
    gen = torch.Generator(device=dev).manual_seed(21)
    k_n = 8 * PRESTEP_ROWS
    x, buf, cnt, act = (v.clone() for v in random_states(params, (k_n, 1), gen))
    lane = torch.arange(k_n, device=dev) % PRESTEP_ROWS
    warp = torch.arange(k_n, device=dev) // PRESTEP_ROWS
    near = torch.tensor([0.4999, -0.4999, 0.0, 0.25, 0.5, -0.5, 0.5001, 3.0], device=dev)
    vel = near[(lane % 2) * 4 + (lane // 2) % 4]
    vel = torch.where(warp == 0, 0.98 * torch.rand(k_n, generator=gen, device=dev) - 0.49, vel)
    vel = torch.where(warp == 1, 0.6 + 7 * torch.rand(k_n, generator=gen, device=dev), vel)
    x[:, 0, 3] = vel
    act[:, 0, 1] = torch.where(lane % 3 == 0, 10.0, act[:, 0, 1])
    got = _prestep_bit_equal(cfg, params, (x, buf, cnt, act))
    ks = (vel.abs() < 0.5).reshape(-1, PRESTEP_ROWS)
    assert ks[0].all() and not ks[1].any() and bool((ks.any(1) & ~ks.all(1)).any()), \
        "fixture guard: warps of each kind"
    crossed = (vel.abs() < 0.5) != (got[0][:, 0, 3].abs() < 0.5)
    assert crossed.any(), "fixture guard: no row changed branch within the step"


def test_prestep_takes_strided_inputs(gpu_params):
    """Views that are not contiguous (a slice of wider rows, a transpose)
    give the outputs of their contiguous copies."""
    cfg, params = gpu_params
    gen = torch.Generator(device=params.rtex.rt.device).manual_seed(5)
    x, buf, cnt, act = random_states(params, (2, 300), gen)
    wide = torch.cat([x, x[..., :3]], dim=-1)[..., :7]
    views = (wide.transpose(0, 1), buf.transpose(0, 1), cnt.t(), act.transpose(0, 1))
    assert not any(v.is_contiguous() for v in views)
    got = _prestep_bit_equal(cfg, params, views)
    want = state_kernels.prestep(cfg, params, *(v.contiguous() for v in views),
                                 state_kernels.pack_params(params.vehicle, params.tmap,
                                                           params.rtex))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_prestep_reads_replaced_params(gpu_params):
    """Fault C1 on the card: after vehicle.replace(mu=1.1) the kernel, fed
    the pack of the replaced params, equals the twin on those params bit
    for bit, and mu moves the result."""
    cfg, params = gpu_params
    new = params._replace(vehicle=params.vehicle.replace(mu=1.1))
    gen = torch.Generator(device=params.rtex.rt.device).manual_seed(12)
    args = random_states(params, (1001, 2), gen)
    got = _prestep_bit_equal(cfg, new, args,
                             state_kernels.pack_params(new.vehicle, new.tmap, new.rtex))
    old = state_kernels.prestep_reference(cfg, params, *args)
    assert float((got[0] - old[0]).abs().max()) > 1e-4, "fixture guard: mu moved nothing"


def test_kernel_rejects_what_it_cannot_take(gpu_params):
    cfg, params = gpu_params
    ops = _operands(cfg, params, 8, torch.bfloat16)
    dev = ops["rt"].device
    for key, bad, match in [
            ("fmat", ops["fmat"].double(), "fmat must be float32"),
            ("scal", ops["scal"].double(), "scal must be float32"),
            ("rows", ops["rows"].long(), "rows must be int32")]:
        with pytest.raises(ValueError, match=match):
            scan_kernels.mega_edge_ttc(**{**ops, key: bad})
    with pytest.raises(ValueError, match="rt_theta_bins=128"):
        scan_kernels.mega_edge_ttc(**{**ops, "t_bins": 256,
                                      "rt": torch.zeros((4, 5 * 256), device=dev)})
    with pytest.raises(ValueError, match="pool_off must be int32"):
        scan_kernels.mega_edge_ttc(**{**ops, "noise": params.noise_pool,
                                      "pool_off": torch.zeros(1, dtype=torch.int64,
                                                              device=dev)})
    # 1000 opponents need 2.6 MB of shared memory a block: refused, and said so
    k_n = ops["rows"].shape[0]
    with pytest.raises(RuntimeError, match="launch failed"):
        scan_kernels.mega_edge_ttc(**{**ops, "sines": params.tables.beam_sines,
                                      "opp": torch.zeros((k_n, 10_000), device=dev)})
    args = random_states(params, (4, 2), torch.Generator(device=dev))
    pack = state_kernels.pack_params(params.vehicle, params.tmap, params.rtex)
    with pytest.raises(ValueError, match="steer_cnt must be int32"):
        state_kernels.prestep(cfg, params, *args[:2], args[2].long(), args[3], pack)
    with pytest.raises(ValueError, match="pack_params"):
        state_kernels.prestep(cfg, params, *args, None)


# The megakernel's tiles: its render kernel (csrc/edge_render.cuh) takes 64
# rows a block tile and 64 beams a beam tile, its spectra kernel
# (csrc/mega_edge_ttc.cu) 32 rows a tile.  Row counts near the render's
# block edges (BM - 1, BM, BM + 1, which straddle the spectra tiles too, and
# 3 BM + 4) for 1 to 4 agents (rounded up to a multiple of the agents),
# beam counts on both sides of a beam tile and 1081 (the 4-byte-copy
# path), every variant, bf16 and float32 storage (texture, noise and e/w
# taps), and the pool offset at 0 and at rows - 37.
MEGA_BM, MEGA_BN = 64, 64
MEGA_ROWS = [(-(-k // a) * a, a)
             for k in (2, MEGA_BM - 1, MEGA_BM, MEGA_BM + 1, 3 * MEGA_BM + 4)
             for a in (1, 2, 3, 4)]
MEGA_ALL = ("plain", "opp", "pool_rot", "opp+pool_rot")
MEGA_EDGES = (
    [(k, a, 1080, v, "bfloat16", 37) for k, a in MEGA_ROWS
     for v in (("plain", "pool_rot") if a == 1 else ("opp", "opp+pool_rot"))]
    + [(3 * MEGA_BM + 4, 2, b, v, "bfloat16", 37)
       for b in (MEGA_BN - 4, MEGA_BN + 4, 1081) for v in MEGA_ALL]
    + [(MEGA_BM + 2, 2, b, v, "float32", 37) for b in (1080, 1081) for v in MEGA_ALL]
    + [(3 * MEGA_BM + 4, 2, b, v, "bfloat16", None) for b in (1080, 1081)
       for v in ("pool_rot", "opp+pool_rot")])


@pytest.fixture(scope="module")
def params_by_beams(gpu_params):
    """{B: (cfg, params)} on demand: the gpu_params config at B beams."""
    cache = {gpu_params[0].num_beams: gpu_params}

    def get(b_n):
        if b_n not in cache:
            cfg = dataclasses.replace(gpu_params[0], num_beams=b_n)
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("RED_GYM_TPU_TEXTURE_CACHE", "off")
                cache[b_n] = cfg, env.make_params(cfg, assets.named_map_yaml(TRACK),
                                                  device=torch.device("cuda"))
        return cache[b_n]
    return get


@pytest.mark.parametrize("k_n, agents, b_n, variant, dtype, back", MEGA_EDGES,
                         ids=lambda v: str(v))
def test_mega_tile_edges_match_plain_twin(params_by_beams, k_n, agents, b_n, variant,
                                          dtype, back):
    """Each megakernel variant at row and beam counts around its blocks:
    the scan bar of _check_against_twin and equal hits; the pool offset is
    rows - back (0 when back is None).  The guards (some hits, some beams
    shortened by an opponent) hold from 3 BM rows on."""
    cfg, params = params_by_beams(b_n)
    dev = params.rtex.rt.device
    gen = torch.Generator(device=dev).manual_seed(k_n * 7 + b_n + agents)
    e_n = k_n // agents
    poses = (close_poses(params, e_n, agents, gen) if agents > 1
             else random_free_poses(params, e_n, gen)[:, None])
    vel = -2.0 + 10.0 * torch.rand((e_n, agents), generator=gen, device=dev)
    opp = pool_off = None
    if "pool_rot" in variant:
        noise = params.noise_pool
        off = 0 if back is None else cfg.noise_pool_rows - back
        pool_off = torch.tensor([off], dtype=torch.int32, device=dev)
    else:
        noise = params.noise_pool[torch.randint(0, cfg.noise_pool_rows, (e_n,),
                                                generator=gen, device=dev)]
    if "opp" in variant:
        verts = collision.get_vertices(poses, params.vehicle.length, params.vehicle.width)
        opp = agent_scan.opponent_slab_scalars(poses, verts, params.tables)
    f32 = dtype == "float32"
    ops = scan_fast.mega_operands(poses, params.tables, params.tmap, params.rtex, cfg,
                                  noise.float() if f32 else noise, vel, opp=opp,
                                  pool_off=pool_off)
    if f32:
        ops.update(rt=ops["rt"].float(), ew_dtype=torch.float32)
    before = scan_kernels.mega_edge_ttc.launches[variant]
    out, hit = scan_kernels.mega_edge_ttc(**ops)
    assert scan_kernels.mega_edge_ttc.launches[variant] == before + 1
    ref, ref_hit = scan_kernels.mega_edge_ttc_reference(**ops)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    assert out.shape == (k_n, b_n) and torch.isfinite(out).all()
    assert float(torch.quantile(err.flatten(), 0.99)) < 1e-3
    assert float((err > 4 * float(params.rtex.cell)).float().mean()) < 2e-3
    assert torch.equal(hit, ref_hit)
    if k_n >= 3 * MEGA_BM:
        assert hit.sum() > 0, "fixture guard: no iTTC hits"
        if opp is not None:
            base, _ = scan_kernels.mega_edge_ttc_reference(
                **{**ops, "opp": None, "sines": None})
            assert (out < base - 1e-6).any(), "fixture guard: no beam shortened"


def test_mega_variants_hold_their_blocks(gpu_params):
    """Every instance of the megakernel's two kernels fits the blocks a SM
    its __launch_bounds__ pins: the spectra kernel's S_MIN_BLOCKS
    (csrc/mega_edge_ttc.cu) and the render kernel's MIN_BLOCKS
    (csrc/edge_render.cuh)."""
    import re
    from pathlib import Path

    csrc = Path(scan_kernels.__file__).parents[1] / "csrc"
    pinned = {
        "spectra": int(re.search(r"constexpr int S_MIN_BLOCKS = (\d+);",
                                 (csrc / "mega_edge_ttc.cu").read_text()).group(1)),
        "render": int(re.search(r"constexpr int MIN_BLOCKS = (\d+);",
                                (csrc / "edge_render.cuh").read_text()).group(1))}
    for n_opp, pool in ((0, False), (0, True), (1, False), (1, True), (3, True)):
        for rt_bf16 in (True, False):
            for noise_bf16 in (True, False):
                blocks = scan_kernels.resident_blocks(n_opp, pool, rt_bf16, noise_bf16)
                assert blocks.keys() == pinned.keys()
                for kernel, n in pinned.items():
                    assert blocks[kernel] >= n, (kernel, n_opp, pool, rt_bf16, noise_bf16)


@pytest.mark.parametrize("rt_dtype, ew_dtype", [("bfloat16", "bfloat16"),
                                                ("float32", "float32"),
                                                ("bfloat16", "float32")])
@pytest.mark.parametrize("k_n", [2, 31, 32, 33, 3 * 32 + 4, 2002])
def test_mega_spectra_kernel_matches_plain_twin(gpu_params, k_n, rt_dtype, ew_dtype):
    """The spectra kernel alone (scan_kernels.mega_stages(1, ...)) against
    mega_spectra_reference, at row counts around its 32-row tiles: f_s,
    wsum and vel exactly equal; the spectra within one bf16 step of the
    twin's, |diff| <= 2^-7 |twin| + 1e-6, and all but 1 % of them within
    2^-20 |twin| + 1e-6.  Not bit-equal, because the kernel sums the rfft
    in float64 in another order than the twin's float64 matmul (a float32
    rounding of the sum can then differ by one step, which the bf16
    rounding of the e/w spectra can widen to one bf16 step) and its cosf,
    sinf and atan2f may differ from PyTorch's in the last bit."""
    _spectra_against_twin(gpu_params, k_n, rt_dtype, ew_dtype)


@pytest.mark.parametrize("k_n", [33, 3 * 32 + 4])
def test_mega_spectra_kernel_takes_negative_heading_bins(gpu_params, k_n):
    """The spectra kernel with integer heading bins i_f in [-300, -1]
    (scal[:, 3]; the env's own producers give [0, T)): the twiddle's phase
    index i_f * l mod T is a floor-mod as in the twin, so the rows agree
    under the bar of test_mega_spectra_kernel_matches_plain_twin."""
    gen = torch.Generator().manual_seed(k_n)
    i_f = torch.randint(-300, 0, (k_n,), generator=gen).float()
    _spectra_against_twin(gpu_params, k_n, "bfloat16", "bfloat16", i_f)


def _spectra_against_twin(gpu_params, k_n, rt_dtype, ew_dtype, i_f=None):
    """The spectra kernel's workspace against mega_spectra_reference on
    k_n rows of random free poses (with i_f, if given, as their integer
    heading bins): per-row outputs exact, spectra within the bar above."""
    cfg, params = gpu_params
    dev = params.rtex.rt.device
    e_n = -(-k_n // 2)
    gen = torch.Generator(device=dev).manual_seed(k_n + 11)
    poses = random_free_poses(params, e_n * 2, gen).reshape(e_n, 2, 3)
    vel = -2.0 + 10.0 * torch.rand((e_n, 2), generator=gen, device=dev)
    ops = scan_fast.mega_operands(poses, params.tables, params.tmap, params.rtex, cfg,
                                  params.noise_pool[:e_n], vel)
    ops.update(rt=ops["rt"].to(getattr(torch, rt_dtype)), ew_dtype=getattr(torch, ew_dtype),
               rows=ops["rows"][:k_n].contiguous(), scal=ops["scal"][:k_n].contiguous(),
               agents_per_env=1, noise=params.noise_pool[:1].expand(k_n, -1).contiguous())
    if i_f is not None:
        ops["scal"][:, 3] = i_f.to(dev)
    ws = scan_kernels.mega_workspace(k_n, 128, dev)
    scan_kernels.mega_stages(1, ws, **ops)
    spec, f_s, wsum, vel_r = scan_kernels.mega_spectra_reference(
        ops["rt"], ops["rows"], ops["scal"], ops["fmat"], ops["fmat_sw"], ops["shift1"],
        ops["max_range"], 128, ops["ew_dtype"])
    torch.cuda.synchronize()
    got = ws[:k_n * 384].reshape(k_n, 384)
    rows = ws[k_n * 384:].reshape(3, k_n)
    assert torch.equal(rows[0], f_s) and torch.equal(rows[1], wsum)
    assert torch.equal(rows[2], vel_r)
    assert torch.isfinite(got).all()
    err = (got - spec).abs()
    assert bool((err <= 2.0 ** -7 * spec.abs() + 1e-6).all()), float(err.max())
    assert float((err > 2.0 ** -20 * spec.abs() + 1e-6).float().mean()) < 0.01


# The edge epilogues 6, 3 and 4 on csrc/edge_render.cuh (the megakernel's
# render kernel): 64 rows a block tile, 64 beams a beam tile.  Row counts
# around the block tile (BM - 1, BM, BM + 1, 3 BM + 4), beam counts 1080,
# on both sides of a beam tile and 1081 (the 4-byte path), bf16 and float32
# e/w taps and noise.
RENDER_BM, RENDER_BN = 64, 64
RENDER_EDGES = (
    [(name, k, 1080, "bfloat16") for k in (RENDER_BM - 1, RENDER_BM, RENDER_BM + 1,
                                           3 * RENDER_BM + 4)
     for name in ("theta_shuffle_blend_edge", "theta_shuffle_blend_edge_ttc",
                  "theta_shuffle_blend_edge_ttc_opp")]
    + [(name, 3 * RENDER_BM + 4, b, dt) for b in (RENDER_BN - 4, RENDER_BN + 4, 1081)
       for dt in ("bfloat16", "float32")
       for name in ("theta_shuffle_blend_edge", "theta_shuffle_blend_edge_ttc",
                    "theta_shuffle_blend_edge_ttc_opp")])


@pytest.mark.parametrize("name, k_n, b_n, dtype", RENDER_EDGES, ids=lambda v: str(v))
def test_render_tile_edges_match_plain_twin(params_by_beams, name, k_n, b_n, dtype):
    """Each edge epilogue at row and beam counts around the render tile, on
    the bilinear prep chain's spectra (one agent a car, or for the opponent
    form cars within 2.5 m of each other): the scan bar and equal hits; the
    guards (some hits, some beams shortened by an opponent) hold from
    3 BM rows on."""
    from chip_smoke import blend_operands
    from red_gym_tpu_torch.ops import blend_kernels

    agents = 1
    if name.endswith("_opp"):   # opponents: 2 agents, or 3 for an odd row count
        agents = 3 if k_n % 2 else 2
        k_n = -(-k_n // agents) * agents
    cfg, params = params_by_beams(b_n)
    cfg = dataclasses.replace(cfg, num_agents=agents, rt_spatial="bilinear")
    dev = params.rtex.rt.device
    gen = torch.Generator(device=dev).manual_seed(k_n * 5 + b_n)
    e_n = k_n // agents
    poses = (close_poses(params, e_n, agents, gen) if agents > 1
             else random_free_poses(params, e_n, gen)[:, None])
    kw = blend_operands(cfg, params, poses, gen)[name]
    f32 = dtype == "float32"
    kw["ew_dtype"] = torch.float32 if f32 else torch.bfloat16
    if "noise" in kw and f32:
        kw["noise"] = kw["noise"].float()
    kernel = getattr(blend_kernels, name)
    before = kernel.launches
    got = kernel(**kw)
    assert kernel.launches == before + 1
    want = getattr(blend_kernels, name + "_reference")(**kw)
    torch.cuda.synchronize()
    out, ref = (got[0], want[0]) if isinstance(got, tuple) else (got, want)
    err = (out - ref).abs()
    assert out.shape == (k_n, b_n) and torch.isfinite(out).all()
    assert float(torch.quantile(err.flatten(), 0.99)) < 1e-3
    assert float((err > 4 * float(params.rtex.cell)).float().mean()) < 2e-3
    if isinstance(got, tuple):
        assert torch.equal(got[1], want[1])
        if k_n >= 3 * RENDER_BM:
            assert got[1].sum() > 0, "fixture guard: no iTTC hits"
    if name.endswith("_opp") and k_n >= 3 * RENDER_BM:
        base, _ = blend_kernels.theta_shuffle_blend_edge_ttc_reference(
            **{k: v for k, v in kw.items() if k not in ("sines", "opp")})
        assert (out < base - 1e-6).any(), "fixture guard: no beam shortened"


BLEND_CASES = (
    [("theta_shuffle_blend", None, None, a) for a in (1, 2, 3)]
    + [("theta_shuffle_blend_edge", ew, None, a)
       for ew in ("bfloat16", "float32") for a in (1, 2, 3)]
    + [(name, ew, nd, a)
       for name, agents in (("theta_shuffle_blend_edge_ttc", (1, 2, 3)),
                            ("theta_shuffle_blend_edge_ttc_opp", (2, 3)))
       for ew in ("bfloat16", "float32") for nd in ("bfloat16", "float32")
       for a in agents])


@pytest.mark.parametrize("name, ew, noise_dtype, agents", BLEND_CASES,
                         ids=lambda v: str(v))
def test_blend_kernels_match_plain_twin(gpu_params, name, ew, noise_dtype, agents):
    """Each epilogue kernel against its twin on the bilinear config's rolled
    spectra of 1001 envs (a partial last block), cars within 2.5 m, over
    e/w tap dtype, noise storage dtype and agent count."""
    from chip_smoke import blend_operands
    from red_gym_tpu_torch.ops import blend_kernels

    cfg, params = gpu_params
    cfg = dataclasses.replace(cfg, num_agents=agents, rt_spatial="bilinear")
    dev = params.rtex.rt.device
    gen = torch.Generator(device=dev).manual_seed(6)
    poses = (close_poses(params, 1001, agents, gen) if agents > 1
             else random_free_poses(params, 1001, gen)[:, None])
    kw = blend_operands(cfg, params, poses, gen)[name]
    if ew is not None:
        kw["ew_dtype"] = getattr(torch, ew)
    if noise_dtype is not None:
        kw["noise"] = kw["noise"].to(getattr(torch, noise_dtype))
    kernel = getattr(blend_kernels, name)
    before = kernel.launches
    got = kernel(**kw)
    assert kernel.launches == before + 1
    want = getattr(blend_kernels, name + "_reference")(**kw)
    torch.cuda.synchronize()
    out, ref = (got[0], want[0]) if isinstance(got, tuple) else (got, want)
    err = (out - ref).abs()
    assert torch.isfinite(out).all()
    assert float(torch.quantile(err.flatten(), 0.99)) < 1e-3
    assert float((err > 4 * float(params.rtex.cell)).float().mean()) < 2e-3
    if isinstance(got, tuple):
        assert torch.equal(got[1], want[1])
        assert got[1].sum() > 0, "fixture guard: no iTTC hits"
    if name.endswith("_opp"):
        base, _ = blend_kernels.theta_shuffle_blend_edge_ttc_reference(
            **{k: v for k, v in kw.items() if k not in ("sines", "opp")})
        assert (out < base - 1e-6).any(), "fixture guard: no beam shortened"


def test_blend_kernels_reject_what_they_cannot_take(gpu_params):
    from chip_smoke import blend_operands
    from red_gym_tpu_torch.ops import blend_kernels

    cfg, params = gpu_params
    dev = params.rtex.rt.device
    gen = torch.Generator(device=dev).manual_seed(7)
    ops = blend_operands(dataclasses.replace(cfg, rt_spatial="bilinear"), params,
                         close_poses(params, 8, 2, gen), gen)
    kw = ops["theta_shuffle_blend_edge_ttc_opp"]
    fn = blend_kernels.theta_shuffle_blend_edge_ttc_opp
    for key, bad, match in [
            ("spec_r", kw["spec_r"].double(), "spec must be float32"),
            ("vel", kw["vel"].half(), "vel must be float32"),
            ("noise", kw["noise"].half(), "noise must be bfloat16 or float32"),
            ("ew_dtype", torch.float16, "ew_dtype must be")]:
        with pytest.raises(ValueError, match=match):
            fn(**{**kw, key: bad})
    wide = torch.zeros((16, 256), device=dev)
    with pytest.raises(ValueError, match="rt_theta_bins=128"):
        blend_kernels.theta_shuffle_blend(wide, kw["f_s"], kw["wsum"],
                                          torch.zeros((256, 3 * 1080), device=dev),
                                          kw["c_frac"], 30.0)
    # 1000 opponents need 2.6 MB of shared memory a block: refused, and said so
    with pytest.raises(RuntimeError, match="launch failed"):
        fn(**{**kw, "opp": torch.zeros((16, 10_000), device=dev)})
    # the unfused scan's float32 matrix products refuse TF32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        poses = close_poses(params, 8, 2, gen)
        with pytest.raises(RuntimeError, match="full float32 matrix products"):
            scan_fast.trace_fast_mxu(poses, params.tables, params.tmap, params.rtex,
                                     dataclasses.replace(cfg, rt_spatial="bilinear"))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def _steps_gpu_and_cpu(cfg, params_g, pool):
    """One reset + 5 steps on the GPU (kernels) and on the CPU (plain twins)
    from identical inputs and noise pool -> {device: (x, scans, collisions)}."""
    def on(dev):
        def move(v):
            if v is None:
                return None
            if isinstance(v, tuple):
                return type(v)(*[move(t) for t in v])
            return v.to(dev)
        return move(params_g._replace(noise_pool=pool))

    poses = torch.as_tensor(np.tile(assets.waypoint_start_poses(TRACK, 2)[None],
                                    (64, 1, 1)), dtype=torch.float32)
    actions = torch.rand((6, 64, 2, 2), generator=torch.Generator().manual_seed(0))
    actions[..., 0] = 0.8 * actions[..., 0] - 0.4
    actions[..., 1] = 1.0 + 7.0 * actions[..., 1]
    out = {}
    for dev in ("cuda", "cpu"):
        params = on(dev)
        gen = torch.Generator(device=dev)
        s, o, *_ = rollout.batched_reset(cfg, params, poses.to(dev), gen)
        for i in range(5):
            s, o, *_ = rollout.batched_step(cfg, params, s, actions[i].to(dev), gen)
        out[dev] = (s.x.cpu(), o.scans.cpu(), s.collisions.cpu())
    return out


@pytest.mark.parametrize("mode", ["bilinear", "bilinear_ttc_off", "legacy"])
def test_unfused_env_step_on_gpu_matches_cpu(gpu_params, mode):
    """The unfused scan's modes: bilinear (kernel 4), bilinear with
    fuse_scan_ttc="off" (kernel 6) and legacy (kernel 7, on the range
    channel of the texture) on the GPU against the CPU twins, on an
    all-equal bf16 pool."""
    from red_gym_tpu_torch.ops import blend_kernels

    _, params_g = gpu_params
    kw = dict(bilinear={}, bilinear_ttc_off=dict(fuse_scan_ttc="off"),
              legacy=dict(rt_occlusion="off", rt_grad=False))[mode]
    cfg = SimConfig(num_agents=2, num_beams=1080, scan_mode="fast", rt_pose_stride=8,
                    ttc_thresh=0.5, rt_spatial="bilinear", rt_ew_dtype="bfloat16", **kw)
    if mode == "legacy":
        params_g = params_g._replace(rtex=params_g.rtex._replace(
            rt=params_g.rtex.rt[:, :cfg.rt_theta_bins].contiguous()))
    row = 0.01 * torch.randn((1, cfg.num_beams), generator=torch.Generator().manual_seed(1))
    pool = row.expand(cfg.noise_pool_rows, -1).to(torch.bfloat16)
    blend_kernels.reset_launches()
    out = _steps_gpu_and_cpu(cfg, params_g, pool)
    assert sum(fn.launches for fn in blend_kernels.KERNELS) == 6
    x_g, scan_g, coll_g = out["cuda"]
    x_c, scan_c, coll_c = out["cpu"]
    torch.testing.assert_close(x_g, x_c, rtol=0, atol=1e-4)
    err = (scan_g - scan_c).abs()
    assert float(torch.quantile(err.flatten(), 0.99)) < 1e-3
    assert torch.equal(coll_g, coll_c)


def _ultra(params_g, **kw):
    """bench.py's ultra config and the gpu_params texture's range channel
    (the 1-channel texture it reads)."""
    cfg = SimConfig(num_agents=kw.pop("num_agents", 2), num_beams=1080,
                    scan_mode="fast", rt_pose_stride=8, ttc_thresh=0.5,
                    scan_interp="spectral", rt_occlusion="off", rt_grad=False, **kw)
    params = params_g._replace(rtex=params_g.rtex._replace(
        rt=params_g.rtex.rt[:, :cfg.rt_theta_bins].contiguous()))
    return cfg, params


@pytest.mark.parametrize("noise_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("agents", [1, 2, 3])
def test_spectral_kernel_matches_plain_twin(gpu_params, noise_dtype, agents):
    """Kernel 5 against its twin on the ultra config's rolled spectra of
    1001 envs (a partial last block of 32 rows), cars within 2.5 m."""
    from chip_smoke import spectral_operands
    from red_gym_tpu_torch.ops import spectral_kernels

    cfg, params = _ultra(gpu_params[1], num_agents=agents)
    dev = params.rtex.rt.device
    gen = torch.Generator(device=dev).manual_seed(9)
    poses = (close_poses(params, 1001, agents, gen) if agents > 1
             else random_free_poses(params, 1001, gen)[:, None])
    kw = spectral_operands(cfg, params, poses, gen)
    kw["noise"] = kw["noise"].to(getattr(torch, noise_dtype))
    kernel = spectral_kernels.theta_spectral_ttc
    before = kernel.launches
    out, hit = kernel(**kw)
    assert kernel.launches == before + 1
    ref, ref_hit = spectral_kernels.theta_spectral_ttc_reference(**kw)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    assert torch.isfinite(out).all()
    assert float(err.max()) < 1e-3
    assert float(torch.quantile(err.flatten(), 0.99)) < 1e-4
    assert torch.equal(hit, ref_hit)
    assert hit.sum() > 0, "fixture guard: no iTTC hits"


def test_spectral_kernel_rejects_what_it_cannot_take(gpu_params):
    from chip_smoke import spectral_operands
    from red_gym_tpu_torch.ops import spectral_kernels

    cfg, params = _ultra(gpu_params[1])
    dev = params.rtex.rt.device
    gen = torch.Generator(device=dev).manual_seed(10)
    kw = spectral_operands(cfg, params, close_poses(params, 8, 2, gen), gen)
    fn = spectral_kernels.theta_spectral_ttc
    for key, bad, match in [
            ("spec_r", kw["spec_r"].double(), "spec_r must be float32"),
            ("smat", kw["smat"].double(), "smat must be float32"),
            ("vel", kw["vel"].half(), "vel must be float32"),
            ("noise", kw["noise"].half(), "noise must be bfloat16 or float32")]:
        with pytest.raises(ValueError, match=match):
            fn(**{**kw, key: bad})
    with pytest.raises(ValueError, match="rt_theta_bins=128"):
        fn(**{**kw, "spec_r": torch.zeros((16, 256), device=dev),
              "smat": torch.zeros((256, 1080), device=dev)})


# The tiles of csrc/rowtile_gemm.cuh: 128 rows a block; 128 beams a tile for
# kernel 5, 64 for kernel 7.  Row counts near the tile's edges (rounded up
# to a multiple of agents_per_env), beam counts on both sides of a beam
# tile, and 1081, which takes the 4-byte-copy instance.
BM = 128
EDGE_ROWS = [(-(-k // a) * a, a) for k in (2, BM - 2, BM + 2, 3 * BM + 4) for a in (1, 2, 3)]


def _edge_beams(bn):
    return (1080, 4, bn - 4, bn + 4, 1081)


def _synthetic_spectral(k_n, b_n, agents, noise_dtype, seed):
    """Random operands of kernel 5 whose scans spread over [0, 30] m, with
    masked rows and moving cars, so that some rows hit and some do not."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def u(*shape):
        return torch.rand(shape, generator=gen, device="cuda")

    wsum = u(k_n)
    wsum[::7] = 0.0
    beams = torch.linspace(-2.35, 2.35, b_n, device="cuda")
    noise = 0.01 * torch.randn((k_n // agents, b_n), generator=gen, device="cuda")
    return dict(spec_r=2.0 * u(k_n, 128) - 0.5, wsum=wsum, vel=10.0 * u(k_n) - 2.0,
                smat=0.5 * u(128, b_n), noise=noise.to(noise_dtype),
                cosines=torch.cos(beams), side_dist=0.3 * u(b_n), max_range=30.0,
                ttc_thresh=2.0, agents_per_env=agents)


SPECTRAL_EDGES = ([(k, 1080, a, "bfloat16") for k, a in EDGE_ROWS]
                  + [(3 * BM + 4, b, 2, nd) for b in _edge_beams(128)
                     for nd in ("bfloat16", "float32")])


@pytest.mark.parametrize("k_n, b_n, agents, noise_dtype", SPECTRAL_EDGES,
                         ids=lambda v: str(v))
def test_spectral_kernel_tile_edges_match_plain_twin(gpu_params, k_n, b_n, agents,
                                                     noise_dtype):
    """Kernel 5 at row and beam counts around its tiles: scans within
    1e-4 m of the twin, hit flags exactly equal."""
    from red_gym_tpu_torch.ops import spectral_kernels

    kw = _synthetic_spectral(k_n, b_n, agents, getattr(torch, noise_dtype), k_n + b_n)
    kernel = spectral_kernels.theta_spectral_ttc
    before = kernel.launches
    out, hit = kernel(**kw)
    assert kernel.launches == before + 1
    ref, ref_hit = spectral_kernels.theta_spectral_ttc_reference(**kw)
    torch.cuda.synchronize()
    assert out.shape == (k_n, b_n) and torch.isfinite(out).all()
    assert float((out - ref).abs().max()) <= 1e-4
    assert torch.equal(hit, ref_hit)
    if k_n >= BM - 2:
        assert 0 < int(hit.sum()) < k_n, "fixture guard: hits and misses"


BLEND_EDGES = ([(k, 1080, True) for k in sorted({k for k, _ in EDGE_ROWS})]
               + [(3 * BM + 4, b, strided) for b in _edge_beams(64)
                  for strided in (False, True)])


@pytest.mark.parametrize("k_n, b_n, strided", BLEND_EDGES, ids=lambda v: str(v))
def test_blend_kernel_tile_edges_match_plain_twin(gpu_params, k_n, b_n, strided):
    """Kernel 7 at row and beam counts around its tiles, on contiguous
    spectra and on the strided spec[:, 0] view of (K, 3, T) spectra (row
    stride 3T, read in place): within 1e-4 m of the twin."""
    from red_gym_tpu_torch.ops import blend_kernels

    gen = torch.Generator(device="cuda").manual_seed(k_n * 3 + b_n)

    def u(*shape):
        return torch.rand(shape, generator=gen, device="cuda")

    spec = 2.0 * u(k_n, 3, 128) - 0.5
    wsum = u(k_n)
    wsum[::5] = 0.0
    kw = dict(spec_r=spec[:, 0] if strided else spec[:, 0].contiguous(),
              f_s=0.999 * u(k_n), wsum=wsum, gmat=0.5 * u(128, 3 * b_n), c_frac=u(b_n),
              max_range=30.0)
    kernel = blend_kernels.theta_shuffle_blend
    before = kernel.launches
    out = kernel(**kw)
    assert kernel.launches == before + 1
    ref = blend_kernels.theta_shuffle_blend_reference(**kw)
    torch.cuda.synchronize()
    assert out.shape == (k_n, b_n) and torch.isfinite(out).all()
    assert float((out - ref).abs().max()) <= 1e-4
    assert (out[wsum == 0] == 0).all()


@pytest.mark.parametrize("fuse_scan_ttc", ["auto", "off"])
def test_ultra_env_step_on_gpu_matches_cpu(gpu_params, fuse_scan_ttc):
    """bench.py's ultra mode (kernel 5) and the same with
    fuse_scan_ttc="off" (the plain render and the eager tail) on the GPU
    against the CPU twins, on an all-equal bf16 pool."""
    from red_gym_tpu_torch.ops import spectral_kernels

    cfg, params_g = _ultra(gpu_params[1], fuse_scan_ttc=fuse_scan_ttc)
    row = 0.01 * torch.randn((1, cfg.num_beams), generator=torch.Generator().manual_seed(1))
    pool = row.expand(cfg.noise_pool_rows, -1).to(torch.bfloat16)
    before = spectral_kernels.theta_spectral_ttc.launches
    out = _steps_gpu_and_cpu(cfg, params_g, pool)
    launches = spectral_kernels.theta_spectral_ttc.launches - before
    assert launches == (6 if fuse_scan_ttc == "auto" else 0)
    x_g, scan_g, coll_g = out["cuda"]
    x_c, scan_c, coll_c = out["cpu"]
    torch.testing.assert_close(x_g, x_c, rtol=0, atol=1e-4)
    err = (scan_g - scan_c).abs()
    assert float(torch.quantile(err.flatten(), 0.99)) < 1e-3
    assert torch.equal(coll_g, coll_c)


@pytest.mark.parametrize("noise_mode", ["pool", "fresh", "pool_rot", "eager"])
def test_env_step_on_gpu_matches_cpu(gpu_params, noise_mode):
    """One reset + 5 steps on the GPU (kernels) and the CPU (plain twins)
    from identical inputs.  The generators of the two devices differ, so
    "pool" and "pool_rot" run on a pool whose rows are all equal (bfloat16
    noise in the kernel) and "fresh" runs without noise (float32 noise in
    the kernel).  "eager" is the pool config with the state kernel and the
    fused opponent cast off."""
    _, params_g = gpu_params
    eager = noise_mode == "eager"
    noise_mode = "pool" if eager else noise_mode
    cfg = SimConfig(num_agents=2, num_beams=1080, scan_mode="fast",
                    rt_pose_stride=8, ttc_thresh=0.5, noise_mode=noise_mode,
                    scan_noise_std=0.0 if noise_mode == "fresh" else 0.01,
                    rt_ew_dtype="bfloat16",
                    state_kernel="off" if eager else "auto",
                    fuse_scan_opp="off" if eager else "auto")
    row = 0.01 * torch.randn((1, cfg.num_beams), generator=torch.Generator().manual_seed(1))
    pool = row.expand(cfg.noise_pool_rows, -1).to(torch.bfloat16)
    out = _steps_gpu_and_cpu(cfg, params_g, pool)
    x_g, scan_g, coll_g = out["cuda"]
    x_c, scan_c, coll_c = out["cpu"]
    torch.testing.assert_close(x_g, x_c, rtol=0, atol=1e-4)
    err = (scan_g - scan_c).abs()
    assert float(torch.quantile(err.flatten(), 0.99)) < 1e-3
    assert torch.equal(coll_g, coll_c)


def test_texture_built_on_gpu_matches_cpu(gpu_params):
    """The stride-8 texture marched on the GPU against the CPU build, in
    float32 storage: validity exact, ranges and channels within 1e-3 on all
    but the few bins whose edge bisection a last-bit difference flips."""
    cfg = SimConfig(num_agents=2, num_beams=1080, scan_mode="fast",
                    rt_pose_stride=8, rt_dtype="float32")
    yaml_path = assets.named_map_yaml(TRACK)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RED_GYM_TPU_TEXTURE_CACHE", "off")
        rt = {dev: scan_fast.build_range_texture(
            load_map(yaml_path, dtype=torch.float32, device=dev), cfg)
            for dev in ("cuda", "cpu")}
    assert torch.equal(rt["cuda"].valid.cpu(), rt["cpu"].valid)
    err = (rt["cuda"].rt.cpu() - rt["cpu"].rt).abs()
    assert float((err <= 1e-3).float().mean()) >= 0.999


@pytest.fixture(scope="module")
def gpu_maps():
    """track_0019 on the GPU in float32 and float64, with theta tables."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    out = {}
    for dt in ("float32", "float64"):
        cfg = SimConfig(dtype=dt)
        tmap = load_map(assets.named_map_yaml(TRACK), dtype=cfg.tdtype,
                        device=torch.device("cuda"))
        out[dt] = (tmap, scan.build_tables(cfg, 0.31, 0.58, device=torch.device("cuda")))
    return out


def _march_both(form, tmap, tables, cfg, poses, gen):
    """Kernel and twin of one march form on the same operands; the rays
    form casts 16 rays from each pose at random angles."""
    if form == "beams":
        before = march_kernels.march_beams.launches
        got = march_kernels.march_beams(poses, tables.cosines, tables.sines, tmap, cfg)
        assert march_kernels.march_beams.launches == before + 1
        want = march_kernels.march_beams_reference(poses, tables.cosines, tables.sines,
                                                   tmap, cfg)
        return got, want
    shape = poses.shape[:-1] + (16,)
    x = poses[..., 0:1].expand(shape)
    y = poses[..., 1:2].expand(shape)
    ang = 2 * torch.pi * torch.rand(shape, generator=gen, device=poses.device,
                                    dtype=poses.dtype)
    c, s_ = torch.cos(ang), torch.sin(ang)
    before = march_kernels.march.launches
    got = march_kernels.march(x, y, c, s_, tmap, cfg)
    assert march_kernels.march.launches == before + 1
    return got, march_kernels.march_reference(x, y, c, s_, tmap, cfg)


@pytest.mark.parametrize("march_iters", [0, 40])
@pytest.mark.parametrize("form", ["beams", "rays"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_march_kernel_bit_equal_to_twin(gpu_maps, dtype, form, march_iters):
    tmap, tables = gpu_maps[dtype]
    cfg = SimConfig(dtype=dtype, march_iters=march_iters)
    gen = torch.Generator(device="cuda").manual_seed(3)
    poses = map_free_poses(tmap, 512, gen).reshape(256, 2, 3)
    got, want = _march_both(form, tmap, tables, cfg, poses, gen)
    torch.cuda.synchronize()
    assert got.dtype == tmap.dt.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert float(got.mean()) > 0.5 and float(got.max()) <= cfg.max_range


# ray counts around a warp's 32 lanes and the march kernel's 256-thread
# block
RAY_COUNTS = [1, 31, 32, 33, 63, 65, 255, 256, 257, 511, 513, 4097]


@pytest.mark.parametrize("n", RAY_COUNTS)
def test_march_kernel_ray_counts_around_the_block(gpu_maps, n):
    """Both forms at ray counts around a warp and the kernel's 256-thread
    block: rays n, and beams of one car (B = n) and of n cars (B = 3)."""
    tmap, tables = gpu_maps["float32"]
    gen = torch.Generator(device="cuda").manual_seed(n)
    poses = map_free_poses(tmap, n, gen)
    x, y = poses[:, 0], poses[:, 1]
    ang = 2 * torch.pi * torch.rand((n,), generator=gen, device="cuda")
    cfg = SimConfig()
    got = march_kernels.march(x, y, torch.cos(ang), torch.sin(ang), tmap, cfg)
    assert torch.equal(got, march_kernels.march_reference(
        x, y, torch.cos(ang), torch.sin(ang), tmap, cfg))
    for rows, beams in ((poses[:1], max(n, 2)), (poses, 3)):
        c = dataclasses.replace(cfg, num_beams=beams)
        got = march_kernels.march_beams(rows, tables.cosines, tables.sines, tmap, c)
        assert got.shape == (rows.shape[0], beams)
        assert torch.equal(got, march_kernels.march_beams_reference(
            rows, tables.cosines, tables.sines, tmap, c))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_march_kernel_reads_the_out_of_map_cell(gpu_maps, dtype):
    """Origins and ray tips outside the map read dt[h-1, w-1], as the twin
    does; the headings include the wrap at 0 and 2 pi."""
    tmap, tables = gpu_maps[dtype]
    gen = torch.Generator(device="cuda").manual_seed(5)
    dt = tmap.dt.dtype
    n = 1024
    x = tmap.orig_x + (torch.rand((n,), generator=gen, device="cuda", dtype=dt) * 1.4 - 0.2) \
        * tmap.width.to(dt) * tmap.resolution
    y = tmap.orig_y + (torch.rand((n,), generator=gen, device="cuda", dtype=dt) * 1.4 - 0.2) \
        * tmap.height.to(dt) * tmap.resolution
    th = torch.rand((n,), generator=gen, device="cuda", dtype=dt) * 14.0 - 7.0
    th[:4] = torch.tensor([0.0, 2 * torch.pi, torch.pi, -torch.pi], dtype=dt)
    poses = torch.stack([x, y, th], dim=-1)
    out = march_kernels.dt_lookup(x, y, tmap)
    assert (out == tmap.dt[-1, -1]).any(), "fixture guard: no origin outside the map"
    cfg = SimConfig(dtype=dtype, num_beams=540)
    got = march_kernels.march_beams(poses, tables.cosines, tables.sines, tmap, cfg)
    assert torch.equal(got, march_kernels.march_beams_reference(
        poses, tables.cosines, tables.sines, tmap, cfg))


def test_march_kernel_rejects_what_it_cannot_take(gpu_maps):
    tmap, tables = gpu_maps["float32"]
    poses = torch.zeros((4, 3), device="cuda")
    cfg = SimConfig()
    with pytest.raises(ValueError, match="float32 or float64"):
        march_kernels.march_beams(poses.half(), tables.cosines, tables.sines, tmap, cfg)
    with pytest.raises(ValueError, match="cosines"):
        march_kernels.march_beams(poses, tables.cosines.double(), tables.sines, tmap, cfg)
    with pytest.raises(ValueError, match="tmap.dt"):
        march_kernels.march_beams(poses.double(), tables.cosines.double(),
                                  tables.sines.double(), tmap, SimConfig(dtype="float64"))
    with pytest.raises(ValueError, match="one device and dtype"):
        march_kernels.march(poses[:, 0], poses[:, 1].double(), poses[:, 0], poses[:, 1],
                            tmap, cfg)


def test_texture_marched_by_the_kernel_equals_the_twins(gpu_maps, monkeypatch):
    """The stride-8 texture built on the GPU with its rays marched by the
    kernel and by the twin (``march_kernels.march`` swapped), float32
    storage: rt and valid torch.equal."""
    tmap, _ = gpu_maps["float32"]
    cfg = SimConfig(num_agents=2, num_beams=1080, scan_mode="fast", rt_pose_stride=8,
                    rt_dtype="float32")
    monkeypatch.setenv("RED_GYM_TPU_TEXTURE_CACHE", "off")
    before = march_kernels.march.launches
    by_kernel = scan_fast.build_range_texture(tmap, cfg)
    assert march_kernels.march.launches > before
    monkeypatch.setattr(march_kernels, "march", march_kernels.march_reference)
    by_twin = scan_fast.build_range_texture(tmap, cfg)
    assert torch.equal(by_kernel.rt, by_twin.rt)
    assert torch.equal(by_kernel.valid, by_twin.valid)


def test_exact_f110env_step_on_gpu_matches_cpu(gpu_maps):
    """An exact-mode F110Env (the default scan mode) reset + 5 steps on the
    GPU (the march kernel) and on the CPU (its twin), without scan noise
    (the two devices' generators differ): poses within 1e-4 m, scans at
    the float32 bar with map cells, collisions equal."""
    envs = {dev: env.F110Env(map=assets.named_map_yaml(TRACK), scan_noise_std=0.0,
                             ttc_thresh=0.5, device=dev) for dev in ("cuda", "cpu")}
    assert envs["cuda"].cfg.scan_mode == "exact"
    poses = assets.waypoint_start_poses(TRACK, 2)
    act = np.array([[0.2, 4.0], [-0.1, 3.0]])
    before = march_kernels.march_beams.launches
    obs = {dev: [e.reset(poses)[0]] + [e.step(act)[0] for _ in range(5)]
           for dev, e in envs.items()}
    assert march_kernels.march_beams.launches == before + 6
    res = float(envs["cpu"].params.tmap.resolution)
    for og, oc in zip(obs["cuda"], obs["cpu"]):
        for k in ("poses_x", "poses_y", "poses_theta"):
            np.testing.assert_allclose(og[k], oc[k], rtol=0, atol=1e-4, err_msg=k)
        err = np.abs(og["scans"].astype(np.float64) - oc["scans"])
        assert np.quantile(err, 0.99) < 1e-3
        assert np.mean(err > 4 * res) < 2e-3
        np.testing.assert_array_equal(og["collisions"], oc["collisions"])


# ---------------------------------------------------------------------------
# multi-map batches: the march kernel's stacked form and the megakernel on a
# stacked texture
# ---------------------------------------------------------------------------

BERLIN = os.path.join(assets.DATA_DIR, "classic", "berlin.yaml")
STACK = [assets.named_map_yaml(TRACK), BERLIN, assets.named_map_yaml("track_narrow")]


@pytest.fixture(scope="module")
def gpu_stack():
    """Three maps of different resolution, origin and extent stacked on the
    GPU in float32 and float64 (exact mode, no texture), with theta tables,
    and each map alone (the raw map)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    out = {}
    for dt in ("float32", "float64"):
        cfg = SimConfig(dtype=dt, num_agents=2)
        params = env.make_multimap_params(cfg, STACK, device=torch.device("cuda"))
        alone = [map_of_stack(params.tmap, m, unpad=True) for m in range(len(STACK))]
        out[dt] = (params.tmap, params.tables, alone)
    return out


def _stack_poses(alone, midx, gen):
    return per_map_poses(lambda m, n: map_free_poses(alone[m], 2 * n, gen).reshape(n, 2, 3),
                         midx, 2)


@pytest.mark.parametrize("march_iters", [0, 40])
@pytest.mark.parametrize("form", ["beams", "rays"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_march_kernel_stacked_bit_equal_to_twin(gpu_stack, dtype, form, march_iters):
    """Both forms over a stack, map indices 0 to M - 1 (first and last
    included), torch.equal to the twin."""
    tmap, tables, alone = gpu_stack[dtype]
    cfg = SimConfig(dtype=dtype, march_iters=march_iters)
    gen = torch.Generator(device="cuda").manual_seed(13)
    midx = (torch.arange(300, device="cuda") % len(STACK)).to(torch.int32)
    poses = _stack_poses(alone, midx, gen)
    rows = midx[:, None].expand(300, 2)
    if form == "beams":
        before = march_kernels.march_beams.launches
        got = march_kernels.march_beams(poses, tables.cosines, tables.sines, tmap, cfg, rows)
        assert march_kernels.march_beams.launches == before + 1
        want = march_kernels.march_beams_reference(poses, tables.cosines, tables.sines, tmap,
                                                   cfg, rows)
    else:
        shape = poses.shape[:-1] + (16,)
        ang = 2 * torch.pi * torch.rand(shape, generator=gen, device="cuda",
                                        dtype=poses.dtype)
        args = (poses[..., 0:1].expand(shape), poses[..., 1:2].expand(shape),
                torch.cos(ang), torch.sin(ang), tmap, cfg, rows[..., None].expand(shape))
        got = march_kernels.march(*args)
        want = march_kernels.march_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert float(got.mean()) > 0.5


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_march_kernel_stacked_rays_leave_their_map(gpu_stack, dtype):
    """Origins around each map's true extents: a ray outside its map reads
    dt[m, h_m - 1, w_m - 1] of its own map, on the kernel as on the twin."""
    tmap, tables, alone = gpu_stack[dtype]
    gen = torch.Generator(device="cuda").manual_seed(14)
    n = 999
    midx = (torch.arange(n, device="cuda") % len(STACK)).to(torch.int32)
    dt = tmap.dt.dtype
    u = torch.rand((n, 3), generator=gen, device="cuda", dtype=dt)
    ext_x = tmap.width[midx].to(dt) * tmap.resolution[midx]
    ext_y = tmap.height[midx].to(dt) * tmap.resolution[midx]
    x = tmap.orig_x[midx] + (u[:, 0] * 1.4 - 0.2) * ext_x
    y = tmap.orig_y[midx] + (u[:, 1] * 1.4 - 0.2) * ext_y
    poses = torch.stack([x, y, u[:, 2] * 14.0 - 7.0], dim=-1)
    d0 = march_kernels.dt_lookup(x, y, tmap, midx)
    corner = tmap.dt[midx.long(), tmap.height[midx].long() - 1, tmap.width[midx].long() - 1]
    for m in range(len(STACK)):
        assert bool(((d0 == corner) & (midx == m)).any()), f"no origin outside map {m}"
    cfg = SimConfig(dtype=dtype, num_beams=540)
    got = march_kernels.march_beams(poses, tables.cosines, tables.sines, tmap, cfg, midx)
    assert torch.equal(got, march_kernels.march_beams_reference(
        poses, tables.cosines, tables.sines, tmap, cfg, midx))


@pytest.mark.parametrize("n", RAY_COUNTS)
def test_march_kernel_stacked_ray_counts_around_the_block(gpu_stack, n):
    """The stacked form at the ray counts of
    ``test_march_kernel_ray_counts_around_the_block``: rays n on maps
    i % M, beams of one car (B = n) and of n cars (B = 3) on maps i % M."""
    tmap, tables, alone = gpu_stack["float32"]
    gen = torch.Generator(device="cuda").manual_seed(n + 7)
    midx = (torch.arange(n, device="cuda") % len(STACK)).to(torch.int32)
    poses = _stack_poses(alone, midx, gen)[:, 0]
    ang = 2 * torch.pi * torch.rand((n,), generator=gen, device="cuda")
    cfg = SimConfig()
    args = (poses[:, 0], poses[:, 1], torch.cos(ang), torch.sin(ang), tmap, cfg, midx)
    assert torch.equal(march_kernels.march(*args), march_kernels.march_reference(*args))
    for rows, beams, m in ((poses[:1], max(n, 2), midx[:1]), (poses, 3, midx)):
        c = dataclasses.replace(cfg, num_beams=beams)
        got = march_kernels.march_beams(rows, tables.cosines, tables.sines, tmap, c, m)
        assert got.shape == (rows.shape[0], beams)
        assert torch.equal(got, march_kernels.march_beams_reference(
            rows, tables.cosines, tables.sines, tmap, c, m))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_march_kernel_stacked_equals_standalone(gpu_stack, dtype):
    """The envs of each map, marched on the stack, torch.equal the same
    poses marched on that map alone; and the one-map form equals the
    stacked form on a one-map stack (index 0), so the one-map path keeps
    its result."""
    tmap, tables, alone = gpu_stack[dtype]
    cfg = SimConfig(dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(15)
    midx = (torch.arange(600, device="cuda") % len(STACK)).to(torch.int32)
    poses = _stack_poses(alone, midx, gen)
    got = march_kernels.march_beams(poses, tables.cosines, tables.sines, tmap, cfg,
                                    midx[:, None])
    for m in range(len(STACK)):
        sel = torch.nonzero(midx == m).squeeze(1)
        one = march_kernels.march_beams(poses[sel], tables.cosines, tables.sines, alone[m],
                                        cfg)
        assert torch.equal(got[sel], one), m
        single = stack_maps([alone[m]])
        assert torch.equal(one, march_kernels.march_beams(
            poses[sel], tables.cosines, tables.sines, single, cfg,
            torch.zeros(sel.numel(), 1, dtype=torch.int32, device="cuda")))


def test_march_kernel_stacked_rejects_what_it_cannot_take(gpu_stack):
    tmap, tables, alone = gpu_stack["float32"]
    poses = torch.zeros((4, 2, 3), device="cuda")
    cfg = SimConfig()
    midx = torch.zeros((4, 2), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="needs a map index"):
        march_kernels.march_beams(poses, tables.cosines, tables.sines, tmap, cfg)
    with pytest.raises(ValueError, match="takes none"):
        march_kernels.march_beams(poses, tables.cosines, tables.sines, alone[0], cfg, midx)
    with pytest.raises(ValueError, match="midx must be int32"):
        march_kernels.march_beams(poses, tables.cosines, tables.sines, tmap, cfg, midx.long())


@pytest.fixture(scope="module")
def gpu_stack_fast():
    """The stride-8 default textures of STACK stacked on the GPU, and each
    map's own params."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = SimConfig(num_agents=2, num_beams=1080, scan_mode="fast", rt_pose_stride=8,
                    ttc_thresh=0.5)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RED_GYM_TPU_TEXTURE_CACHE", "off")
        params = env.make_multimap_params(cfg, STACK, device=torch.device("cuda"))
        alone = [env.make_params(cfg, y, device=torch.device("cuda")) for y in STACK]
    return cfg, params, alone


def _mega_stack_operands(cfg, params, midx, gen):
    e_n = midx.numel()
    dev = midx.device
    poses = per_map_poses(lambda m, n: close_poses(params_of_stack(params, m), n, 2, gen),
                          midx, 2)
    vel = -2.0 + 10.0 * torch.rand((e_n, 2), generator=gen, device=dev)
    noise = params.noise_pool[torch.randint(0, cfg.noise_pool_rows, (e_n,), generator=gen,
                                            device=dev)]
    verts = collision.get_vertices(poses, params.vehicle.length, params.vehicle.width)
    opp = agent_scan.opponent_slab_scalars(poses, verts, params.tables)
    return poses, vel, noise, opp


def test_mega_on_stacked_texture_matches_plain_twin(gpu_stack_fast):
    """The megakernel with opponents on the flat view of a stacked texture
    at the scan bar of its twin, hits equal; 1001 envs (a partial block)."""
    cfg, params, _ = gpu_stack_fast
    gen = torch.Generator(device="cuda").manual_seed(16)
    midx = (torch.arange(1001, device="cuda") % len(STACK)).to(torch.int32)
    poses, vel, noise, opp = _mega_stack_operands(cfg, params, midx, gen)
    ops = scan_fast.mega_operands(poses, params.tables, params.tmap, params.rtex, cfg, noise,
                                  vel, opp=opp, midx=midx[:, None])
    assert ops["rt"].shape == (len(STACK) * params.rtex.rt.shape[1], 640)
    _check_against_twin(params._replace(rtex=params.rtex._replace(
        cell=params.rtex.cell.min())), ops, "opp")


def test_mega_on_stacked_texture_equals_standalone(gpu_stack_fast):
    """For every map, the megakernel's rows of that map's envs on the
    stacked texture torch.equal the same operands on that map alone."""
    cfg, params, alone = gpu_stack_fast
    gen = torch.Generator(device="cuda").manual_seed(17)
    midx = (torch.arange(900, device="cuda") % len(STACK)).to(torch.int32)
    poses, vel, noise, opp = _mega_stack_operands(cfg, params, midx, gen)
    out, hit = scan_kernels.mega_edge_ttc(**scan_fast.mega_operands(
        poses, params.tables, params.tmap, params.rtex, cfg, noise, vel, opp=opp,
        midx=midx[:, None]))
    out, hit = out.reshape(900, 2, -1), hit.reshape(900, 2)
    for m, one in enumerate(alone):
        sel = torch.nonzero(midx == m).squeeze(1)
        o, h = scan_kernels.mega_edge_ttc(**scan_fast.mega_operands(
            poses[sel], one.tables, one.tmap, one.rtex, cfg, noise[sel], vel[sel],
            opp=opp[sel]))
        assert torch.equal(o.reshape(-1, 2, o.shape[-1]), out[sel]), m
        assert torch.equal(h.reshape(-1, 2), hit[sel]), m


@pytest.mark.parametrize("mode", ["default", "bilinear", "ultra", "exact"])
def test_multimap_rollout_on_gpu_matches_cpu(gpu_stack_fast, mode):
    """A multi-map reset + 5 steps on the GPU (the kernels) and on the CPU
    (their twins) from the same params (made on the GPU, moved), bf16 e/w
    taps on both, without scan noise: poses within 1e-4 m, scans at the
    float32 bar with the finer map's texture cells, collisions equal; the
    state kernel does not run."""
    cfg, _, _ = gpu_stack_fast
    cfg = dataclasses.replace(cfg, scan_noise_std=0.0, rt_ew_dtype="bfloat16", **{
        "default": {}, "bilinear": dict(rt_spatial="bilinear"),
        "ultra": dict(scan_interp="spectral", rt_occlusion="off", rt_grad=False),
        "exact": dict(scan_mode="exact")}[mode])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RED_GYM_TPU_TEXTURE_CACHE", "off")
        params_g = env.make_multimap_params(cfg, STACK[:2], device="cuda")

    def move(v, dev):
        if v is None:
            return None
        if isinstance(v, tuple):
            return type(v)(*[move(t, dev) for t in v])
        return v.to(dev)

    cell = float(params_g.tmap.resolution.min() if params_g.rtex is None
                 else params_g.rtex.cell.min())
    starts = torch.as_tensor(np.stack([assets.waypoint_start_poses(TRACK, 2),
                                       np.array([[0.0, 0.0, 0.0], [0.0, -1.0, 0.0]])]),
                             dtype=torch.float32)
    midx = torch.tensor([0, 1, 1, 0], dtype=torch.int32)
    act = torch.tensor([0.1, 3.0]).expand(4, 2, 2)
    runs = {}
    for dev in ("cuda", "cpu"):
        params = move(params_g, dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        before = state_kernels.prestep.launches
        seq = [rollout.batched_reset(cfg, params, starts[midx.long()].to(dev), gen,
                                     map_idx=midx.to(dev))[:2]]
        for _ in range(5):
            seq.append(rollout.batched_step(cfg, params, seq[-1][0], act.to(dev), gen)[:2])
        assert state_kernels.prestep.launches == before
        runs[dev] = seq
    for (sg, og), (sc, oc) in zip(runs["cuda"], runs["cpu"]):
        np.testing.assert_allclose(sg.x.cpu().numpy(), sc.x.numpy(), rtol=0, atol=1e-4)
        err = (og.scans.cpu() - oc.scans).abs()
        assert float(torch.quantile(err.flatten(), 0.99)) < 1e-3
        assert float((err > 4 * cell).float().mean()) < 2e-3
        assert torch.equal(sg.collisions.cpu(), sc.collisions)


# ---------------------------------------------------------------------------
# VecF110Env on the card
# ---------------------------------------------------------------------------

VEC_ENVS = 1024


@pytest.fixture(scope="module")
def gpu_vec():
    """A VecF110Env of 1024 envs in the library-default fast scan after 150
    steps of random actions within the action bounds (past the first wave
    of crashes), and 30 more actions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RED_GYM_TPU_TEXTURE_CACHE", "off")
        vec = vec_env.VecF110Env(assets.named_map_yaml(TRACK), VEC_ENVS, num_agents=2,
                                 scan_mode="fast", rt_pose_stride=8, return_final_obs=True,
                                 device="cuda")
    lo, hi = (torch.as_tensor(b, device="cuda") for b in env.action_bounds(vec.params.vehicle))
    gen = torch.Generator(device="cuda").manual_seed(0)
    acts = lo + (hi - lo) * torch.rand((180, VEC_ENVS, 2, 2), generator=gen, device="cuda")
    vec.reset(assets.waypoint_start_poses(TRACK, 2))
    for a in acts[:150]:
        vec.step(a)
    return vec, acts[150:]


def test_vec_env_launches_its_kernels_once_a_step(gpu_vec):
    vec, acts = gpu_vec
    reset_launch_counts()
    resets = sum(bool(vec.step(a)[2].any()) for a in acts[:10])
    counts = launch_counts()
    for name, n in counts.items():
        want = 10 + resets if name in ("mega_edge_ttc[opp]", "prestep") else 0
        assert n == want, (name, n, want)


def test_vec_env_equals_the_hand_loop(gpu_vec):
    vec, acts = gpu_vec
    same, resets, obs = vec_hand_loop(vec, acts[10:])
    assert all(same.values()), same
    assert resets > 0, "no auto-reset in the window"
    assert obs["scans"].is_cuda and torch.isfinite(obs["scans"]).all()


# ---------------------------------------------------------------------------
# the rasterizer's kernels (csrc/rasterize.cu) and the planning env
# ---------------------------------------------------------------------------


def _raster_points(n, beams, seed=0):
    """(n, beams, 2) int32 endpoints of fuzzed scans on a 256 x 256 canvas:
    ranges up to 20 m (many endpoints off the canvas), some beams 0."""
    from red_gym_tpu_torch.ops import rasterize

    gen = torch.Generator(device="cuda").manual_seed(seed)
    scans = 20.0 * torch.rand((n, 1080), generator=gen, device="cuda")
    scans[torch.rand((n, 1080), generator=gen, device="cuda") < 0.05] = 0.0
    return scans, rasterize.beam_endpoints(scans, beams, (256, 256), 10.0)


@pytest.mark.parametrize("n,beams", [(1, 600), (3, 600), (5, 1080), (2, 7)])
def test_raster_kernels_equal_their_twins(n, beams):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    from red_gym_tpu_torch.ops import raster_kernels as rk

    _, pts = _raster_points(n, beams, seed=n)
    t = rk.segment_t(pts.device)
    before = (rk.fill_polygon.launches, rk.draw_segments.launches)
    assert torch.equal(rk.fill_polygon(pts, (256, 256)), rk.fill_polygon_reference(pts, (256, 256)))
    center = torch.full_like(pts, 128)
    for starts, ends in ((pts, torch.roll(pts, -1, dims=-2)), (center, pts)):
        mk = rk.draw_segments(torch.zeros((n, 256, 256), dtype=torch.uint8, device="cuda"),
                              starts, ends, t)
        mr = rk.draw_segments_reference(torch.zeros_like(mk), starts, ends, t)
        assert torch.equal(mk, mr)
    assert (rk.fill_polygon.launches, rk.draw_segments.launches) == (before[0] + 1,
                                                                     before[1] + 2)


def _raster_case(name):
    """(points (n, k, 2) int32 of the fill, segment starts and ends of the
    draw, (h, w), the mask the draw starts from, t) of one edge case of the
    rasterizer's kernels, on the card."""
    from red_gym_tpu_torch.ops import raster_kernels as rk

    gen = torch.Generator(device="cuda").manual_seed(sum(map(ord, name)))
    dims, t, base = (256, 256), rk.segment_t(torch.device("cuda", 0)), None

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda", dtype=torch.int32)

    if name == "zigzag":   # 600 edges, each spanning the whole canvas and beyond
        k = torch.arange(600, device="cuda")
        pts = torch.stack([k * 256 // 600, torch.where(k % 2 == 0, -3, 259)], -1)
        pts = pts.to(torch.int32)[None]
    elif name in ("zero_length", "zero_length_one"):   # on the canvas and far off it
        pts = ints(-300, 300, (1 if name.endswith("one") else 3, 500, 2))
        pts[0, :40] = ints(-9000, 9000, (40, 2))
        return pts, pts, pts.clone(), dims, base, t
    elif name == "off_canvas":
        pts = ints(300, 900, (2, 300, 2)) * torch.tensor([1, -1], dtype=torch.int32,
                                                         device="cuda")
        return pts, pts, pts + ints(-50, 50, pts.shape), dims, base, t
    elif name in ("k1", "k2"):
        pts = _raster_points(2, int(name[1]), seed=5)[1]
    elif name in ("k12288", "k20000"):   # the earlier fill's largest K, and past it
        dims = (24, 40)
        pts = ints(-10, 50, (1, int(name[1:]), 2))
    elif name in ("128x96", "257x129", "520x520"):
        dims = tuple(map(int, name.split("x")))
        gen_s = torch.Generator(device="cuda").manual_seed(3)
        scans = 20.0 * torch.rand((3, 1080), generator=gen_s, device="cuda")
        from red_gym_tpu_torch.ops import rasterize

        pts = rasterize.beam_endpoints(scans, 600, dims, 10.0 * min(dims) / 256)
    elif name == "wide":   # past the draw's float form: W > 2^22
        dims = (1, (1 << 22) + 96)
        pts = torch.cat([ints(-1000, dims[1] + 1000, (1, 20, 1)), ints(-2, 3, (1, 20, 1))], -1)
    elif name == "fill_tiles":   # three of the fill's 8192-column tiles
        dims = (4, 20000)
        pts = torch.cat([ints(-500, 20500, (2, 50, 1)), ints(-2, 6, (2, 50, 1))], -1)
    elif name == "fill_wide":   # pixel indices past 2^24, which float32 rounds (both ties:
        w = (1 << 24) + 4000      # crossings at x = 2^24 + 1000 and 2^24 + 2002)
        dims = (2, w)
        x0, x1 = (1 << 24) + 1000, (1 << 24) + 2002
        pts = torch.tensor([[[x0, -1], [x0, 3], [x1, 3], [x1, -1]],
                            [[w - 9001, 0], [w - 2, 3], [w + 7, 0], [w - 3000, -2]]],
                           dtype=torch.int32, device="cuda")
    elif name == "one_image":
        pts = _raster_points(1, 600, seed=11)[1]
    elif name == "mask_holding_ones":
        pts = _raster_points(3, 600, seed=12)[1]
        base = (torch.rand((3, *dims), generator=gen, device="cuda") < 0.2).to(torch.uint8)
    elif name in ("t_1000", "t_430"):   # other tables; 430 samples end inside the
        pts = _raster_points(2, 600, seed=13)[1]       # last 32-sample iteration
        t = torch.rand(int(name[2:]), generator=gen, device="cuda")
    return pts, pts, torch.roll(pts, -1, dims=-2), dims, base, t


RASTER_CASES = ["zigzag", "zero_length", "zero_length_one", "off_canvas", "k1", "k2",
                "k12288", "k20000", "128x96", "257x129", "520x520", "wide", "fill_tiles",
                "fill_wide", "one_image", "mask_holding_ones", "t_1000", "t_430"]


def test_raster_draw_of_no_samples_launches_nothing():
    """An empty t table leaves the mask as it was and counts no launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    from red_gym_tpu_torch.ops import raster_kernels as rk

    _, pts = _raster_points(2, 600, seed=14)
    mask = torch.zeros((2, 256, 256), dtype=torch.uint8, device="cuda")
    before = rk.draw_segments.launches
    t = torch.empty(0, dtype=torch.float32, device="cuda")
    assert rk.draw_segments(mask, pts, torch.roll(pts, -1, dims=-2), t) is mask
    assert int(mask.sum()) == 0 and rk.draw_segments.launches == before


@pytest.mark.parametrize("name", RASTER_CASES)
def test_raster_kernel_edge_cases_equal_their_twins(name):
    """The fill and the segment draw torch.equal to their twins, one launch a
    call, on the shapes around their blocks, tiles and forms."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    from red_gym_tpu_torch.ops import raster_kernels as rk

    pts, starts, ends, dims, base, t = _raster_case(name)
    if base is None:
        base = torch.zeros((starts.shape[0], *dims), dtype=torch.uint8, device="cuda")
    before = (rk.fill_polygon.launches, rk.draw_segments.launches)
    got = rk.fill_polygon(pts, dims)
    assert torch.equal(got, rk.fill_polygon_reference(pts, dims))
    drawn = rk.draw_segments(base.clone(), starts, ends, t)
    assert torch.equal(drawn, rk.draw_segments_reference(base.clone(), starts, ends, t))
    assert (rk.fill_polygon.launches, rk.draw_segments.launches) == (before[0] + 1,
                                                                     before[1] + 1)
    if name == "zigzag":
        assert 0 < int(got.sum()) < got.numel()


@pytest.mark.parametrize("mode", ["FILL", "POLYGON", "RAYS"])
def test_lidar_to_bitmap_on_gpu_equals_cpu(mode):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    from red_gym_tpu_torch.ops import rasterize

    scans, _ = _raster_points(3, 600, seed=7)
    for kw in ({}, {"bg_color": "black", "channels": 4, "output_image_dims": (128, 96)}):
        got = rasterize.lidar_to_bitmap(scans, draw_mode=mode, **kw)
        assert got.is_cuda
        assert torch.equal(got.cpu(), rasterize.lidar_to_bitmap(scans.cpu(), draw_mode=mode,
                                                                **kw))


def test_planning_env_step_on_gpu_matches_cpu():
    """Reset + 3 planning steps of 4 envs, float64 exact scan, no noise: the
    march, fill and segment kernels each launched once a step, states
    within 1e-9 of the CPU's, bitmaps and dones equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    from red_gym_tpu_torch.agents import planning_env as pe

    cfg = SimConfig(num_agents=1, num_beams=1080, timestep=0.015, dtype="float64",
                    scan_noise_std=0.0)
    envs = {}
    for dev in ("cuda", "cpu"):
        params = env.make_params(cfg, assets.named_map_yaml(TRACK), device=dev)
        envs[dev] = pe.PlanningEnv(cfg, params, reward_mode="fixed", device=dev)
    poses = torch.as_tensor(assets.waypoint_start_poses(TRACK, 1)[None],
                            dtype=torch.float64).repeat(4, 1, 1)
    poses[:, 0, 2] += torch.arange(4, dtype=torch.float64) * 0.3
    acts = torch.rand((3, 4, 16), generator=torch.Generator().manual_seed(0),
                      dtype=torch.float64) * 2 - 1
    out = {}
    for dev, pe_env in envs.items():
        gen = torch.Generator(device=dev).manual_seed(0)
        ps = pe_env.reset(poses.to(dev), gen)
        reset_launch_counts()
        rec = []
        for a in acts:
            ps, bitmap, reward, done, _ = pe_env.step(ps, a.to(dev), gen)
            rec.append((ps.env_state.x.cpu(), bitmap.cpu(), reward.cpu(), done.cpu()))
        out[dev] = (rec, launch_counts())
    counts = out["cuda"][1]
    for name in ("fill_polygon", "draw_segments", "march[beams]"):
        assert counts[name] == 3, counts
    for (xg, bg, rg, dg), (xc, bc, rc, dc) in zip(out["cuda"][0], out["cpu"][0]):
        torch.testing.assert_close(xg, xc, rtol=0, atol=1e-9)
        assert torch.equal(bg, bc) and torch.equal(dg, dc)
        torch.testing.assert_close(rg, rc, rtol=1e-6, atol=1e-5)


# ---------------------------------------------------------------------------
# the tooling tier: kernel E, the float64 fast scan, the lap-time evaluator
# ---------------------------------------------------------------------------

def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")


EDT_MAPS = assets.packaged_tracks() + [BERLIN, os.path.join(assets.DATA_DIR, "classic",
                                                             "skirk.yaml")]


@pytest.mark.parametrize("path", EDT_MAPS, ids=os.path.basename)
def test_edt_kernel_equals_twin_on_every_map(path):
    """Kernel E bit-equal to its twin (torch.equal) on each packaged map, and
    within scipy's bar (rtol 1e-6, atol 1e-5)."""
    _need_gpu()
    from scipy.ndimage import distance_transform_edt
    from red_gym_tpu_torch.maps import loader as map_loader
    from red_gym_tpu_torch.ops import edt_kernels

    occ = map_loader.load_map_image(path[:-len(".yaml")] + ".png")
    res = map_loader.read_map_yaml(path)["resolution"]
    o = torch.as_tensor(occ, device="cuda")
    before = edt_kernels.edt_transform.launches
    got = edt_kernels.edt_transform(o, res)
    assert edt_kernels.edt_transform.launches == before + 1
    assert torch.equal(got, edt_kernels.edt_reference(o, res))
    np.testing.assert_allclose(got.cpu().numpy(), distance_transform_edt(occ) * res,
                               rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("shape, density", [((64, 64), 0.05), ((63, 41), 0.3), ((1, 1), 0.0),
                                            ((9, 11), 0.0), ((9, 11), 1.0), ((2896, 7), 0.01),
                                            ((7, 3000), 0.01), ((1000, 1300), 0.01),
                                            ((257, 255), 0.5), ((2048, 2048), "hall_2048"),
                                            ((2048, 2048), "one_zero_2048"),
                                            ((1024, 1024), "free_1024"), ((300, 257), "rows"),
                                            ((257, 1100), "cols"), ((120, 801), 0.01),
                                            ((120, 431), 0.01), ((120, 33), 0.01)])
def test_edt_kernel_block_edges_and_degenerate_grids(shape, density):
    """Rows and columns around the kernels' blocks and tiles, all-free
    (JAX's sentinel) and all-occupied grids, the long-search grids of
    chip_smoke.edt_long_searches, walls only in rows 0 and H - 1 (rows
    with no zero pixel between them) or only in columns 0 and W - 1, and
    widths that are no multiple of 4 or 32: torch.equal to the twin, one
    launch counted."""
    _need_gpu()
    from red_gym_tpu_torch.ops import edt_kernels

    if density in ("rows", "cols"):
        o = torch.ones(shape, dtype=torch.float32, device="cuda")
        if density == "rows":
            o[[0, -1], :] = 0
        else:
            o[:, [0, -1]] = 0
    elif isinstance(density, str):
        o = edt_long_searches(torch.device("cuda"))[density]
    else:
        rng = np.random.default_rng(shape[0] * 7 + shape[1])
        o = torch.as_tensor((rng.random(shape) >= density).astype(np.float32), device="cuda")
    assert tuple(o.shape) == shape
    before = edt_kernels.edt_transform.launches
    got = edt_kernels.edt_transform(o, 0.05)
    assert edt_kernels.edt_transform.launches == before + 1
    assert torch.equal(got, edt_kernels.edt_reference(o, 0.05))


def test_float64_fast_scan_on_gpu_matches_cpu():
    """The float64 fast scan (prep chain + xla_tail, the texture marched in
    float64 by the march kernel) on the card against the same call on the
    CPU with the card's texture: within 1e-9 m; no scan kernel launched."""
    _need_gpu()
    cfg = SimConfig(num_agents=2, num_beams=1080, scan_mode="fast", dtype="float64",
                    rt_pose_stride=8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RED_GYM_TPU_TEXTURE_CACHE", "off")
        gp = env.make_params(cfg, assets.named_map_yaml(TRACK), device=torch.device("cuda"))
    assert gp.rtex.rt.dtype == torch.float64
    cp = to_cpu(gp)
    gen = torch.Generator(device="cuda").manual_seed(0)
    poses = random_free_poses(gp, 512, gen).reshape(256, 2, 3)
    reset_launch_counts()
    got = scan_fast.trace_fast_mxu(poses, gp.tables, gp.tmap, gp.rtex, cfg)
    assert not any(launch_counts().values())
    want = scan_fast.trace_fast_mxu(poses.cpu(), cp.tables, cp.tmap, cp.rtex, cfg)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0, atol=1e-9)


def test_laptime_evaluator_float64_gpu_matches_cpu():
    """The CMA-ES evaluator in float64 (exact scan, 64 beams, march_iters
    32) for 4 candidates x 200 steps: the card's fitness within 1e-9 of
    the CPU's, and, since 200 steps (2 s) finish no lap, the race it is
    taken from too: final state and scans within 1e-9, crash flags and
    toggles equal."""
    _need_gpu()
    from red_gym_tpu_torch.agents import pure_pursuit as pp
    from red_gym_tpu_torch.tuning import make_laptime_evaluator

    cfg = SimConfig(num_agents=1, num_beams=64, dtype="float64", march_iters=32,
                    scan_noise_std=0.0)
    pop = {"m": np.array([3.2, 3.74, 3.9, 3.5]), "lf": np.array([0.15, 0.15875, 0.165, 0.16]),
           "tlad": np.array([0.6, 0.82, 1.5, 3.0]), "vgain": np.array([0.8, 1.0, 1.2, 1.4])}
    fit, race = {}, {}
    for dev in ("cuda", "cpu"):
        w = pp.load_waypoints_csv(assets.waypoints_csv(TRACK), device=dev)
        ev = make_laptime_evaluator(cfg, assets.named_map_yaml(TRACK), w, 200,
                                    assets.waypoint_start_poses(TRACK, 1)[0], device=dev)
        state, obs, crashed = ev.rollout(pop)
        fit[dev] = ev.fitness(state, crashed).cpu().numpy()
        race[dev] = [t.cpu().numpy() for t in (state.x, obs.scans, state.lap_times,
                                               state.toggle_list, crashed)]
    np.testing.assert_allclose(fit["cuda"], fit["cpu"], rtol=0, atol=1e-9)
    for got, want in zip(race["cuda"][:3], race["cpu"][:3]):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    for got, want in zip(race["cuda"][3:], race["cpu"][3:]):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [dict(rt_spatial="nearest1", rt_occlusion="edge"),
                                dict(rt_spatial="bilinear", rt_occlusion="snap",
                                     rt_grad=False),
                                dict(rt_spatial="nearest", rt_occlusion="off")])
def test_trace_fast_on_gpu_matches_cpu(gpu_params, kw):
    """The element-gather scan (plain PyTorch) on the card against the same
    call on the CPU with the card's texture, at the float32 scan bar; it
    launches no kernel."""
    cfg, params = gpu_params
    cfg = dataclasses.replace(cfg, **kw)
    rtex = params.rtex
    if not cfg.rt_grad:          # the [R | e w] columns of the edge + grad texture
        t = cfg.rt_theta_bins
        rtex = rtex._replace(rt=rtex.rt[:, :3 * t] if cfg.rt_eff_occlusion == "edge"
                             else rtex.rt[:, :t])
    elif cfg.rt_eff_occlusion != "edge":
        t = cfg.rt_theta_bins
        rtex = rtex._replace(rt=torch.cat([rtex.rt[:, :t], rtex.rt[:, 3 * t:]], dim=1))
    gp = params._replace(rtex=rtex)
    cp = to_cpu(gp)
    gen = torch.Generator(device="cuda").manual_seed(3)
    poses = close_poses(gp, 256, 2, gen)
    reset_launch_counts()
    got = scan_fast.trace_fast(poses, gp.tables, gp.tmap, gp.rtex, cfg)
    assert not any(launch_counts().values())
    want = scan_fast.trace_fast(poses.cpu(), cp.tables, cp.tmap, cp.rtex, cfg)
    err = (got.cpu() - want).abs()
    assert float(err.flatten().quantile(0.99)) < 1e-3
    assert float((err > 4 * float(cp.rtex.cell)).float().mean()) < 2e-3


def test_world_size_one_ppo_update_on_gpu_equals_the_plain_step(tmp_path):
    """A process group of one (NCCL on the card): train_ppo's distributed
    branch at 512 envs takes one iteration torch.equal to the ungrouped
    iteration (the one-process code runs)."""
    _need_gpu()
    from red_gym_tpu_torch.examples import train_ppo
    from red_gym_tpu_torch.parallel import distributed as pdist

    argv = ["--envs", "512", "--iters", "1", "--rollout", "8", "--rt-spatial", "nearest1"]
    dev = torch.device("cuda", 0)
    pdist.initialize(device="cuda")
    try:
        assert torch.distributed.get_backend() == "nccl" and pdist.world_size() == 1
        pa, ha = train_ppo.run(train_ppo.parse_args(
            argv + ["--save", str(tmp_path / "shards")]), dev, True)
    finally:
        pdist.shutdown()
    assert os.path.exists(tmp_path / "shards" / "STEP")
    pb, hb = train_ppo.run(train_ppo.parse_args(argv + ["--save", str(tmp_path / "ck.pt")]),
                           dev, False)
    for a, b in zip(pa.policy.parameters(), pb.policy.parameters()):
        assert torch.equal(a, b)
    assert all(ha[0][k] == hb[0][k] for k in ("loss", "reward_mean", "done_rate",
                                              "speed_mean"))
