"""CUDA-only checks of the port (marker ``cuda``); they skip without a GPU.

This file imports no JAX, so it also runs on a GPU machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

It covers what chip_smoke.py does not: every storage variant of the scan
megakernel (bfloat16 / float32 texture, bfloat16 pool / float32 fresh
noise, bfloat16 / float32 e/w taps), its opponent and pool_rot variants for
2 and 4 agents, row counts that leave a partial block, the state kernel
against its twin, refused launches and wrong dtypes, and whole env steps on
the GPU against the same steps on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import close_poses, random_free_poses, random_states
from red_gym_tpu_torch import assets, env, rollout
from red_gym_tpu_torch.config import Integrator, SimConfig
from red_gym_tpu_torch.maps.loader import load_map
from red_gym_tpu_torch.ops import agent_scan, collision, scan_fast, scan_kernels
from red_gym_tpu_torch.ops import state_kernels

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


@pytest.mark.parametrize("integrator", [Integrator.RK4, Integrator.EULER])
def test_prestep_matches_plain_twin(gpu_params, integrator):
    """1001 x 2 random in-range cars: integer outputs exactly equal, float
    outputs within 1e-6."""
    cfg, params = gpu_params
    cfg = dataclasses.replace(cfg, integrator=integrator)
    gen = torch.Generator(device=params.rtex.rt.device).manual_seed(4)
    args = random_states(params, (1001, 2), gen)
    before = state_kernels.prestep.launches
    got = state_kernels.prestep(cfg, params, *args)
    assert state_kernels.prestep.launches == before + 1
    want = state_kernels.prestep_reference(cfg, params, *args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
    for g, w in ((got[2], want[2]), (got[3], want[3]),
                 (got[4][..., 3:5], want[4][..., 3:5])):
        assert torch.equal(g, w)
    for g, w in zip(got, want):
        assert float((g.float() - w.float()).abs().max()) <= 1e-6


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
    # 1000 opponents need 320 KB of shared memory a block: refused, and said so
    k_n = ops["rows"].shape[0]
    with pytest.raises(RuntimeError, match="launch failed"):
        scan_kernels.mega_edge_ttc(**{**ops, "sines": params.tables.beam_sines,
                                      "opp": torch.zeros((k_n, 10_000), device=dev)})
    args = random_states(params, (4, 2), torch.Generator(device=dev))
    with pytest.raises(ValueError, match="steer_cnt must be int32"):
        state_kernels.prestep(cfg, params, *args[:2], args[2].long(), args[3])
    with pytest.raises(ValueError, match="state_pack"):
        state_kernels.prestep(cfg, params._replace(state_pack=None), *args)


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
    # 1000 opponents need 320 KB of shared memory a block: refused, and said so
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
